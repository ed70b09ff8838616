"""Host-side graph container and the conversions the dense path needs.

A numpy copy of ``repro.graphs.formats``: ``Graph`` (with ``dedup``,
``symmetrize`` and ``remove_isolated``), ``coo_to_dense``, ``coo_to_csr``
and ``pad_edges``; the content identity the serving stack keys its cache
by, ``GraphStats`` and ``graph_digest``; and the out-of-core ingest path.
It stays numpy, so the same seed gives byte-identical graphs in both
packages, the same graph the same digest string, and the same file the
same chunks.

On-disk formats and streaming ingest (the production loading path):

* ``EdgeListReader`` streams ``(src, dst, w)`` chunks out of whitespace
  edge-list text (``u v [w]`` rows, ``#``/``%`` comments — the SNAP
  convention) or the ``RCOO`` binary record format, gunzipping ``*.gz``,
  in bounded memory per chunk; ``write_binary_coo`` / ``write_edge_list``
  write them.
* ``ChunkedCSRBuilder`` folds those chunks into the *canonical* graph —
  deduped (min-weight arc per (src, dst) pair, no self loops), optionally
  symmetrized, optionally isolated-vertex-compacted — bitwise the
  in-memory ``Graph(...).dedup()`` / ``.symmetrize()`` /
  ``.remove_isolated()`` pipeline for any chunking or arrival order, with
  the content ``digest`` computed during the emit pass; ``load_graph`` is
  the one-call form.
* ``build_sharded_adjacency`` feeds chunks straight into a
  ``core.dist_bc.MeshBCContext``, so each rank densifies only its own
  block of the adjacency: the ``(n, n)`` matrix never exists on one host.

No self loops: ``A(i, i) = inf`` structurally, matching the paper
(Section 2.1: ``A(i,j) = w(i,j)`` iff ``(i,j) in E``).
"""
from __future__ import annotations

import dataclasses
import gzip
import hashlib
import io
import os
import re
import struct
from typing import IO, Iterable, Iterator, Optional, Tuple, Union

import numpy as np

# COO chunk: (src, dst, w) int32/int32/float32 host arrays of one length.
CooChunk = Tuple[np.ndarray, np.ndarray, np.ndarray]


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


# --- RCOO binary record format --------------------------------------------
#
# Header: magic b"RCOO", u32 version, i64 n, i64 nnz, u8 flags
# (bit0 = weighted, bit1 = directed), then nnz interleaved little-endian
# (i32 src, i32 dst, f32 w) records. Record-major layout so a gzipped
# stream reads forward-only in bounded chunks (no per-array seeks).

_RCOO_MAGIC = b"RCOO"
_RCOO_HEADER = struct.Struct("<4sIqqB")
_RCOO_RECORD = np.dtype([("src", "<i4"), ("dst", "<i4"), ("w", "<f4")])


def write_binary_coo(path: str, g: Graph) -> str:
    """Write a ``Graph``'s raw arcs as an RCOO file (``.gz`` honored)."""
    rec = np.empty(g.nnz, dtype=_RCOO_RECORD)
    rec["src"], rec["dst"], rec["w"] = g.src, g.dst, g.w
    flags = (1 if np.any(g.w != 1.0) else 0) | (2 if g.directed else 0)
    with _open_binary(path, "wb") as f:
        f.write(_RCOO_HEADER.pack(_RCOO_MAGIC, 1, g.n, g.nnz, flags))
        f.write(rec.tobytes())
    return path


def write_edge_list(path: str, g: Graph, *, weights: Optional[bool] = None
                    ) -> str:
    """Write a whitespace edge list (``.gz`` honored; SNAP-style header)."""
    if weights is None:
        weights = bool(np.any(g.w != 1.0))
    with _open_binary(path, "wb") as fb:
        f = io.TextIOWrapper(fb, encoding="ascii")
        f.write(f"# {g.name}: n={g.n} nnz={g.nnz} "
                f"{'directed' if g.directed else 'undirected'}\n")
        for lo in range(0, g.nnz, 1 << 16):
            hi = min(lo + (1 << 16), g.nnz)
            cols = ([g.src[lo:hi], g.dst[lo:hi], g.w[lo:hi]] if weights
                    else [g.src[lo:hi], g.dst[lo:hi]])
            block = np.stack([np.asarray(c, np.float64) for c in cols], 1)
            # %.9g: 9 significant digits round-trip float32 exactly.
            fmt = "%d %d %.9g" if weights else "%d %d"
            np.savetxt(f, block, fmt=fmt)
        f.flush()
        f.detach()
    return path


def _open_binary(path: str, mode: str) -> IO[bytes]:
    if str(path).endswith(".gz"):
        return gzip.open(path, mode)
    return open(path, mode)


class EdgeListReader:
    """Streaming chunk reader over on-disk edge data (bounded memory).

    Formats (auto-detected from the filename, ``fmt=`` overrides):

    * ``"text"`` — whitespace-separated ``u v [w]`` rows; lines starting
      with ``#`` or ``%`` are comments (SNAP / Matrix-Market-adjacent).
    * ``"rcoo"`` — the RCOO binary record format (``write_binary_coo``),
      detected from a ``.rcoo`` / ``.bin`` suffix.

    A trailing ``.gz`` on either is gunzipped transparently. Iterating
    yields ``(src, dst, w)`` int32/int32/float32 chunks of at most
    ``chunk_edges`` arcs; the reader is restartable (each ``chunks()``
    call reopens the file), which is what lets ``build_sharded_adjacency``
    and the canonicalizing builder share one source. After a full pass,
    ``edges_read`` / ``n_min`` (max id + 1 seen) describe the stream.
    """

    def __init__(self, path: str, *, chunk_edges: int = 1 << 18,
                 fmt: Optional[str] = None, default_weight: float = 1.0):
        if chunk_edges <= 0:
            raise ValueError(f"chunk_edges must be positive, got "
                             f"{chunk_edges}")
        self.path = str(path)
        self.chunk_edges = int(chunk_edges)
        self.default_weight = float(default_weight)
        stem = self.path[:-3] if self.path.endswith(".gz") else self.path
        if fmt is None:
            fmt = ("rcoo" if stem.endswith((".rcoo", ".bin")) else "text")
        if fmt not in ("text", "rcoo"):
            raise ValueError(f"fmt must be 'text' or 'rcoo', got {fmt!r}")
        self.fmt = fmt
        self.edges_read = 0  # arcs yielded by the last full pass
        self.n_min = 0  # max id + 1 over the last full pass
        # Declared metadata, when the file carries it: the RCOO header, or
        # a text comment ("# ...: n=40 ... directed" / SNAP "# Nodes: 4039").
        self.header_n: Optional[int] = None
        self.header_directed: Optional[bool] = None
        self.name = os.path.basename(stem).rsplit(".", 1)[0] or "graph"

    def chunks(self) -> Iterator[CooChunk]:
        self.edges_read = 0
        self.n_min = 0
        it = (self._rcoo_chunks() if self.fmt == "rcoo"
              else self._text_chunks())
        for src, dst, w in it:
            if src.shape[0] == 0:
                continue
            self.edges_read += int(src.shape[0])
            hi = int(max(src.max(), dst.max())) + 1
            self.n_min = max(self.n_min, hi)
            yield src, dst, w

    __iter__ = chunks

    def _rcoo_chunks(self) -> Iterator[CooChunk]:
        with _open_binary(self.path, "rb") as f:
            head = f.read(_RCOO_HEADER.size)
            magic, version, n, nnz, flags = _RCOO_HEADER.unpack(head)
            if magic != _RCOO_MAGIC or version != 1:
                raise ValueError(f"{self.path}: not an RCOO v1 file "
                                 "(bad magic or version)")
            self.header_n = int(n)
            self.header_directed = bool(flags & 2)
            left = int(nnz)
            while left > 0:
                k = min(left, self.chunk_edges)
                buf = f.read(k * _RCOO_RECORD.itemsize)
                if len(buf) < k * _RCOO_RECORD.itemsize:
                    raise ValueError(f"{self.path}: truncated RCOO stream "
                                     f"({left} arcs missing)")
                rec = np.frombuffer(buf, dtype=_RCOO_RECORD)
                yield (rec["src"].astype(np.int32),
                       rec["dst"].astype(np.int32),
                       rec["w"].astype(np.float32))
                left -= k

    def _text_chunks(self) -> Iterator[CooChunk]:
        with _open_binary(self.path, "rb") as fb:
            f = io.TextIOWrapper(fb, encoding="utf-8", errors="replace")
            src, dst, w = [], [], []
            for line in f:
                s = line.strip()
                if not s or s[0] in "#%":
                    self._scan_header_comment(s)
                    continue
                parts = s.split()
                src.append(int(parts[0]))
                dst.append(int(parts[1]))
                w.append(float(parts[2]) if len(parts) > 2
                         else self.default_weight)
                if len(src) >= self.chunk_edges:
                    yield (np.asarray(src, np.int32),
                           np.asarray(dst, np.int32),
                           np.asarray(w, np.float32))
                    src, dst, w = [], [], []
            if src:
                yield (np.asarray(src, np.int32), np.asarray(dst, np.int32),
                       np.asarray(w, np.float32))

    _HEADER_N_RE = re.compile(r"\b(?:n=|Nodes:\s*)(\d+)")

    def _scan_header_comment(self, s: str) -> None:
        """Pick up declared metadata from a ``#`` comment line."""
        m = self._HEADER_N_RE.search(s)
        if m and self.header_n is None:
            self.header_n = int(m.group(1))
        if self.header_directed is None:
            if "undirected" in s.lower():
                self.header_directed = False
            elif "directed" in s.lower():
                self.header_directed = True


def _pack_key(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """(src, dst) -> one int64 key with (src, dst)-lexicographic order.

    Bit-packing instead of ``src * n + dst`` so streaming dedup needs no
    final ``n`` up front; both give the same sort order, which is all the
    canonical form depends on.
    """
    return (src.astype(np.int64) << 32) | dst.astype(np.int64)


def _dedup_sorted(key: np.ndarray, w: np.ndarray
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """Canonical run: sort by (key, w), keep the min-w arc per key.

    Exactly ``Graph.dedup``'s ``lexsort((w, key))`` + first-per-key, so
    composing this over any chunking of the same arc multiset lands on
    identical arrays.
    """
    order = np.lexsort((w, key))
    key, w = key[order], w[order]
    first = np.ones(key.shape[0], dtype=bool)
    first[1:] = key[1:] != key[:-1]
    return key[first], w[first]


@dataclasses.dataclass
class IngestResult:
    """What one streaming ingest pass produced."""

    graph: Graph
    kept: Optional[np.ndarray]  # original ids kept (None: no compaction)
    digest: str  # canonical content digest (== graph_digest(graph))
    edges_read: int  # raw arcs consumed (before dedup/symmetrize)
    n_chunks: int

    @property
    def stats(self) -> GraphStats:
        return GraphStats.from_graph(self.graph, digest=self.digest)


class ChunkedCSRBuilder:
    """Streaming canonicalizer: COO chunks in, canonical ``Graph``/CSR out.

    Feeds arbitrary-order, arbitrary-chunking arc streams through
    ``add(src, dst, w)`` and produces on ``finalize()`` a graph whose
    arrays are **bitwise identical** to the in-memory pipeline
    ``Graph(n, src, dst, w).dedup()`` (+ ``.symmetrize()`` when
    ``symmetrize=True``, + ``.remove_isolated()`` when
    ``remove_isolated=True``) applied to the concatenated stream.

    Memory: each chunk is deduped into a sorted run immediately;
    buffered runs merge-compact whenever they exceed ``buffer_edges``
    arcs, so the peak footprint is O(unique arcs + chunk), never
    O(raw stream). The content digest is accumulated during the final
    emit pass (one extra O(nnz) sweep, no extra copy).
    """

    def __init__(self, n: Optional[int] = None, *, symmetrize: bool = False,
                 remove_isolated: bool = False, directed: bool = True,
                 name: str = "graph", buffer_edges: int = 1 << 22):
        self._n_pin = n
        self._n_seen = 0
        self.symmetrize = bool(symmetrize)
        self.remove_isolated = bool(remove_isolated)
        self.directed = False if symmetrize else bool(directed)
        self.name = name
        self.buffer_edges = int(buffer_edges)
        self._runs: list[Tuple[np.ndarray, np.ndarray]] = []  # (key, w)
        self._buffered = 0
        self._touched = np.zeros(0, dtype=bool)
        self.edges_read = 0
        self.n_chunks = 0
        self._done = False

    # -- streaming side -----------------------------------------------------
    def add(self, src: np.ndarray, dst: np.ndarray,
            w: Optional[np.ndarray] = None) -> None:
        if self._done:
            raise RuntimeError("ChunkedCSRBuilder already finalized")
        src = np.asarray(src, np.int32)
        dst = np.asarray(dst, np.int32)
        w = (np.ones(src.shape[0], np.float32) if w is None
             else np.asarray(w, np.float32))
        if not (src.shape == dst.shape == w.shape):
            raise ValueError("src, dst and w must share one shape")
        self.edges_read += int(src.shape[0])
        self.n_chunks += 1
        if src.shape[0] == 0:
            return
        if src.min() < 0 or dst.min() < 0:
            raise ValueError("negative vertex id in edge chunk")
        hi = int(max(src.max(), dst.max())) + 1
        if self._n_pin is not None and hi > self._n_pin:
            raise ValueError(f"vertex id {hi - 1} out of range for pinned "
                             f"n={self._n_pin}")
        self._n_seen = max(self._n_seen, hi)
        keep = src != dst  # canonical form has no self loops
        src, dst, w = src[keep], dst[keep], w[keep]
        if src.shape[0] == 0:
            return
        self._mark_touched(src, dst)
        if self.symmetrize:
            src, dst = (np.concatenate([src, dst]),
                        np.concatenate([dst, src]))
            w = np.concatenate([w, w])
        key, w = _dedup_sorted(_pack_key(src, dst), w)
        self._runs.append((key, w))
        self._buffered += int(key.shape[0])
        if self._buffered > self.buffer_edges and len(self._runs) > 1:
            self._compact()

    def add_chunks(self, chunks: Iterable[CooChunk]) -> "ChunkedCSRBuilder":
        for src, dst, w in chunks:
            self.add(src, dst, w)
        return self

    def _mark_touched(self, src: np.ndarray, dst: np.ndarray) -> None:
        if self._touched.shape[0] < self._n_seen:
            grown = np.zeros(max(self._n_seen, 2 * self._touched.shape[0]),
                             dtype=bool)
            grown[:self._touched.shape[0]] = self._touched
            self._touched = grown
        self._touched[src] = True
        self._touched[dst] = True

    def _compact(self) -> None:
        key = np.concatenate([k for k, _ in self._runs])
        w = np.concatenate([v for _, v in self._runs])
        key, w = _dedup_sorted(key, w)
        self._runs = [(key, w)]
        self._buffered = int(key.shape[0])

    # -- emit side ----------------------------------------------------------
    def finalize(self) -> IngestResult:
        """Merge runs, compact isolated vertices, digest, build the Graph."""
        self._done = True
        n = self._n_pin if self._n_pin is not None else self._n_seen
        if self._runs:
            self._compact()
            key, w = self._runs[0]
        else:
            key = np.zeros(0, np.int64)
            w = np.zeros(0, np.float32)
        src = (key >> 32).astype(np.int32)
        dst = (key & 0xFFFFFFFF).astype(np.int32)
        kept = None
        if self.remove_isolated:
            touched = np.zeros(n, dtype=bool)
            touched[:min(self._touched.shape[0], n)] = \
                self._touched[:n]
            kept = np.nonzero(touched)[0]
            remap = np.full(n, -1, dtype=np.int32)
            remap[kept] = np.arange(kept.shape[0], dtype=np.int32)
            src, dst = remap[src], remap[dst]
            # remap preserves id order, so (src, dst) sortedness survives
            n = int(kept.shape[0])
        h = hashlib.sha256()
        _digest_update(h, n, self.directed, int(src.shape[0]))
        for lo in range(0, src.shape[0], 1 << 20):
            h.update(src[lo:lo + (1 << 20)].tobytes())
            h.update(dst[lo:lo + (1 << 20)].tobytes())
            h.update(w[lo:lo + (1 << 20)].tobytes())
        g = Graph(n, src, dst, w, directed=self.directed, name=self.name)
        return IngestResult(graph=g, kept=kept, digest=h.hexdigest(),
                            edges_read=self.edges_read,
                            n_chunks=self.n_chunks)


def load_graph(path: str, *, n: Optional[int] = None,
               chunk_edges: int = 1 << 18, symmetrize: bool = False,
               remove_isolated: bool = True, fmt: Optional[str] = None,
               name: Optional[str] = None,
               default_weight: float = 1.0) -> IngestResult:
    """One-call chunked ingest: file → canonical ``Graph`` + digest.

    The production loading path (bounded memory per chunk): a streaming
    ``EdgeListReader`` pass through a ``ChunkedCSRBuilder``. The result's
    arrays are bitwise what the in-memory pipeline would produce on the
    same file, for every ``chunk_edges`` — the parity the ingest tests
    pin down.
    """
    reader = EdgeListReader(path, chunk_edges=chunk_edges, fmt=fmt,
                            default_weight=default_weight)
    builder = ChunkedCSRBuilder(n, symmetrize=symmetrize,
                                remove_isolated=remove_isolated,
                                name=name or reader.name)
    builder.add_chunks(reader.chunks())
    if builder._n_pin is None and reader.header_n:
        builder._n_pin = max(reader.header_n, builder._n_seen)
    if not symmetrize and reader.header_directed is not None:
        # RCOO flags / a text header comment declare directedness; the ids
        # alone cannot. Adopt it so a write → load round trip is identity.
        builder.directed = reader.header_directed
    return builder.finalize()


def as_coo_chunks(source: Union[Graph, IngestResult, EdgeListReader,
                                Iterable[CooChunk]]) -> Iterable[CooChunk]:
    """Normalize an adjacency source into an iterable of COO chunks."""
    if isinstance(source, IngestResult):
        source = source.graph
    if isinstance(source, Graph):
        return [(source.src, source.dst, source.w)]
    if isinstance(source, EdgeListReader):
        return source.chunks()
    return source


def build_sharded_adjacency(source, ctx, *, transform=None):
    """Stream an adjacency into a ``core.dist_bc.MeshBCContext``.

    ``source`` is anything ``as_coo_chunks`` understands — a ``Graph``,
    an ``IngestResult``, a restartable ``EdgeListReader``, or a raw
    iterable of ``(src, dst, w)`` chunks. Each rank keeps the entries of
    each chunk that land in its own blocks of A and Aᵀ (``MeshBCContext.
    upload_coo_chunks``), so the full ``(n, n)`` dense adjacency — the
    thing that cannot exist at scale 18+ — is only ever materialized one
    rank's block at a time. Chunks must already be canonical-enough for
    an adjacency (duplicates fold by min, self loops are dropped; but
    symmetrization is *not* applied here — feed a ``ChunkedCSRBuilder``
    result or a symmetric on-disk file for undirected graphs).

    ``ctx`` must be built for the stream's vertex count, e.g.
    ``MeshBCContext(ingest.stats, mesh, ...)`` — the stats-only
    constructor path that skips the dense upload. ``transform(src, dst,
    w) -> (src, dst, w)`` optionally rewrites each chunk in flight
    (id remapping, weight casts). Returns ``ctx``.
    """
    chunks = as_coo_chunks(source)
    if transform is not None:
        chunks = (transform(*c) for c in chunks)
    ctx.upload_coo_chunks(chunks)
    return ctx
