"""Host-side graph container and the conversions the dense path needs.

A numpy copy of the in-memory half of ``repro.graphs.formats``: ``Graph``
(with ``dedup``, ``symmetrize`` and ``remove_isolated``), ``coo_to_dense``,
``coo_to_csr`` and ``pad_edges``, and the content identity the serving
stack keys its cache by: ``GraphStats`` and ``graph_digest``. It stays
numpy, so the same seed gives byte-identical graphs in both packages, and
the same graph the same digest string. The streaming ingest half
(``EdgeListReader``, ``ChunkedCSRBuilder``) is not ported yet.

No self loops: ``A(i, i) = inf`` structurally, matching the paper
(Section 2.1: ``A(i,j) = w(i,j)`` iff ``(i,j) in E``).
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Optional, Tuple

import numpy as np


@dataclasses.dataclass
class Graph:
    """Host-side COO graph. Directed; undirected graphs store both arcs."""

    n: int
    src: np.ndarray  # (nnz,) int32
    dst: np.ndarray  # (nnz,) int32
    w: np.ndarray  # (nnz,) float32, positive
    directed: bool = True
    name: str = "graph"

    def __post_init__(self) -> None:
        self.src = np.asarray(self.src, dtype=np.int32)
        self.dst = np.asarray(self.dst, dtype=np.int32)
        self.w = np.asarray(self.w, dtype=np.float32)
        assert self.src.shape == self.dst.shape == self.w.shape

    @property
    def nnz(self) -> int:
        return int(self.src.shape[0])

    @property
    def m(self) -> int:
        """Edge count in the paper's sense (arcs for directed graphs)."""
        return self.nnz

    def dedup(self) -> "Graph":
        """Keep the minimum-weight arc for each (src, dst) pair; drop loops."""
        keep = self.src != self.dst
        src, dst, w = self.src[keep], self.dst[keep], self.w[keep]
        key = src.astype(np.int64) * self.n + dst.astype(np.int64)
        order = np.lexsort((w, key))
        key, src, dst, w = key[order], src[order], dst[order], w[order]
        first = np.ones(key.shape[0], dtype=bool)
        first[1:] = key[1:] != key[:-1]
        return Graph(self.n, src[first], dst[first], w[first], self.directed, self.name)

    def symmetrize(self) -> "Graph":
        """Return the undirected version (both arcs present, deduped)."""
        src = np.concatenate([self.src, self.dst])
        dst = np.concatenate([self.dst, self.src])
        w = np.concatenate([self.w, self.w])
        return Graph(self.n, src, dst, w, directed=False, name=self.name).dedup()

    def transpose(self) -> "Graph":
        return Graph(self.n, self.dst, self.src, self.w, self.directed, self.name + "_T")

    def out_degrees(self) -> np.ndarray:
        return np.bincount(self.src, minlength=self.n)

    def remove_isolated(self) -> Tuple["Graph", np.ndarray]:
        """Drop vertices with no incident arcs (paper preprocessing).

        Returns the compacted graph and the array of kept original ids.
        """
        touched = np.zeros(self.n, dtype=bool)
        touched[self.src] = True
        touched[self.dst] = True
        kept = np.nonzero(touched)[0]
        remap = np.full(self.n, -1, dtype=np.int32)
        remap[kept] = np.arange(kept.shape[0], dtype=np.int32)
        return (
            Graph(int(kept.shape[0]), remap[self.src], remap[self.dst], self.w,
                  self.directed, self.name),
            kept,
        )


def coo_to_dense(g: Graph, dtype=np.float32) -> np.ndarray:
    """Dense adjacency with ``inf`` off-structure (min over duplicate arcs)."""
    a = np.full((g.n, g.n), np.inf, dtype=dtype)
    # np.minimum.at handles duplicate (src, dst) pairs.
    np.minimum.at(a, (g.src, g.dst), g.w.astype(dtype))
    np.fill_diagonal(a, np.inf)
    return a


def coo_to_csr(g: Graph) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """CSR (indptr, indices, weights) sorted by (src, dst)."""
    order = np.lexsort((g.dst, g.src))
    src, dst, w = g.src[order], g.dst[order], g.w[order]
    indptr = np.zeros(g.n + 1, dtype=np.int64)
    np.add.at(indptr, src + 1, 1)
    np.cumsum(indptr, out=indptr)
    return indptr, dst, w


def pad_edges(g: Graph, nnz_padded: Optional[int] = None, multiple: int = 128
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Pad the COO arrays to a static size.

    Padding arcs are ``(n-1) -> (n-1)`` with weight ``inf``: a self loop of
    infinite weight never relaxes anything (``f((w, m), inf) = (inf, m)``
    loses every ``min``), so the padding is algebraically invisible.
    """
    if nnz_padded is None:
        nnz_padded = ((g.nnz + multiple - 1) // multiple) * multiple
    nnz_padded = max(nnz_padded, multiple)
    assert nnz_padded >= g.nnz, (nnz_padded, g.nnz)
    pad = nnz_padded - g.nnz
    sink = g.n - 1
    src = np.concatenate([g.src, np.full(pad, sink, np.int32)])
    dst = np.concatenate([g.dst, np.full(pad, sink, np.int32)])
    w = np.concatenate([g.w, np.full(pad, np.inf, np.float32)])
    return src, dst, w


# ==========================================================================
# Content identity: stats-only records and the canonical digest.
# ==========================================================================


@dataclasses.dataclass(frozen=True)
class GraphStats:
    """What the planner needs to size a run, without the edge arrays.

    ``BCPlanner.plan`` / ``plan_for_request`` accept this in place of a
    full ``Graph``: a run can be planned from the stats alone. ``digest``
    is the canonical content digest (``graph_digest``) when known: the key
    the serving stack's result cache addresses answers by.
    """

    n: int
    m: int
    weighted: bool = False
    directed: bool = True
    name: str = "graph"
    digest: Optional[str] = None

    @classmethod
    def from_graph(cls, g: Graph, digest: Optional[str] = None
                   ) -> "GraphStats":
        return cls(n=g.n, m=g.m, weighted=bool(np.any(g.w != 1.0)),
                   directed=g.directed, name=g.name, digest=digest)


_DIGEST_MAGIC = b"repro-graph-v1"


def _digest_update(h, n: int, directed: bool, nnz: int) -> None:
    h.update(_DIGEST_MAGIC)
    h.update(struct.pack("<q?q", n, directed, nnz))


def graph_digest(g: Graph, chunk: int = 1 << 20) -> str:
    """Content digest of the *canonical* arc set (dedup order, min weight).

    Invariant under arc order and duplicate arcs: the digest is taken over
    the ``dedup()``-canonical ``(src, dst, w)`` arrays, streamed in chunks.
    The bytes hashed are ``repro``'s, so both packages give one graph the
    same digest, and an ingest that streams the same canonical arcs shares
    the key.
    """
    c = g.dedup()
    h = hashlib.sha256()
    _digest_update(h, c.n, c.directed, c.nnz)
    for lo in range(0, c.nnz, chunk):
        h.update(c.src[lo:lo + chunk].tobytes())
        h.update(c.dst[lo:lo + chunk].tobytes())
        h.update(c.w[lo:lo + chunk].tobytes())
    return h.hexdigest()
