"""Adjacency containers: dense, COO and frontier-compacted CSR.

``DenseAdj`` wraps an ``(n, n)`` float32 matrix with ``inf`` off-structure
and its transpose, built once at construction so the MFBr loop never
transposes. Its two relaxations go through ``repro_torch.kernels.ops``: on
the card that is always the Hopper kernels. ``CooAdj`` wraps padded edge
arrays and keeps them grouped by dst and by src for the segment sums.
``CsrAdj`` carries the same arcs sorted both ways (by src and by dst) with
row pointers, so its relaxations can compact the active frontier and touch
only incident arc ranges. All expose the two monoid relaxations, the
SP-DAG child count and ``gather_rows``; each is built on an explicit
device.

``CsrAdj`` picks its capacity bucket on the host, from (union columns,
incident arcs) of the frontier: ``mfbf``/``mfbr`` read those two counts
with the frontier count they already take each iteration
(``frontier_counts_mp``/``_cp``), so a sweep still syncs once per
iteration. The reference picks on the device with ``lax.switch``.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device, tracing
from repro_torch.core import monoids
from repro_torch.core.monoids import INF, Centpath, Multpath, Runs
from repro_torch.graphs.formats import Graph, coo_to_dense, pad_edges
from repro_torch.kernels import ops as kops
from repro_torch.kernels.tropical_mm import pick_splits, sm_count


class RelaxStats(NamedTuple):
    """Side output of one frontier-compacted relaxation (host ints).

    ``bucket`` is the capacity-ladder index that served the call
    (``len(caps)`` = the full-edge-list fallback); ``overflow`` is 1 iff
    the fallback ran.
    """

    nnz: int  # union-frontier columns seen by this relax
    arcs: int  # arc slots the frontier's ranges needed
    bucket: int  # ladder index chosen
    overflow: int  # 1 iff the full-edge-list fallback ran


def _gather_rows_scatter(src: torch.Tensor, dst: torch.Tensor,
                         w: torch.Tensor, n: int,
                         sources: torch.Tensor) -> torch.Tensor:
    """Rows of the dense adjacency for ``sources``: (nb, n).

    Scatters each arc's weight into row ``searchsorted(sorted(sources),
    src)`` with one amin over (nb*n + 1) flat segments (the +1 is the dump
    for arcs whose src is not sampled), then maps sorted rows back to the
    callers' order (duplicate sources all read the first occurrence's row).
    """
    nb = sources.shape[0]
    sources = sources.long()
    ss, _ = torch.sort(sources)
    rc = torch.searchsorted(ss, src).clamp(0, nb - 1)
    flat = torch.where(ss[rc] == src, rc * n + dst, nb * n)
    out = torch.full((nb * n + 1,), INF, dtype=w.dtype, device=w.device)
    out.scatter_reduce_(0, flat, w, "amin", include_self=True)
    return out[:-1].reshape(nb, n)[torch.searchsorted(ss, sources)]


@dataclasses.dataclass
class DenseAdj:
    a: torch.Tensor  # (n, n) float32, inf off-structure
    # Transpose hoisted out of the relax loop: made contiguous once here.
    at: Optional[torch.Tensor] = None
    block: int = 512  # u-block of the plain count_sp_children (CPU only)
    # Contraction split count of the kernels on the card; None lets each
    # product pick its own from its shape. Fixed, a row's tie sums do not
    # depend on how many rows share its batch (``for_batches``).
    splits: Optional[int] = None

    def __post_init__(self):
        if self.at is None:
            self.at = self.a.T.contiguous()

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    def for_batches(self, n_b: int) -> "DenseAdj":
        """This adjacency with the split count fixed for every batch of up
        to ``n_b`` rows: the one ``pick_splits`` gives ``n_b`` rows on this
        card (nothing changes on the CPU, whose plain products have no
        slices). The executor serves several padded batch sizes and needs
        each row bitwise the same in all of them."""
        if not self.a.is_cuda:
            return self
        sms = sm_count(self.a.device.index)
        return dataclasses.replace(self,
                                   splits=pick_splits(n_b, self.n, self.n, sms))

    def gather_rows(self, sources: torch.Tensor) -> torch.Tensor:
        return self.a[sources.long()]

    def relax_mp(self, F: Multpath) -> Multpath:
        w, m = kops.multpath_matmul(F.w, F.m, self.a, self.splits)
        return Multpath(w, m)

    def relax_cp(self, F: Centpath) -> Centpath:
        w, p, c = kops.centpath_matmul(F.w, F.p, self.at, self.splits)
        return Centpath(w, p, c)

    def count_sp_children(self, Tw: torch.Tensor) -> torch.Tensor:
        """On the card the Hopper kernel over ``at``; on the CPU the plain
        form over ``a`` in u-blocks of ``block``."""
        return kops.count_sp_children(Tw, self.a, self.at, self.block)


@dataclasses.dataclass
class CooAdj:
    src: torch.Tensor  # (E,) int64, padded
    dst: torch.Tensor  # (E,) int64
    w: torch.Tensor  # (E,) float32, padding = inf
    n_static: int
    # The arcs grouped by dst (MFBF's segments) and by src (MFBr's), both
    # keeping the arc order inside each run; built once here.
    runs_mp: Optional[Runs] = None
    runs_cp: Optional[Runs] = None

    def __post_init__(self):
        if self.runs_mp is None:
            self.runs_mp = monoids.arc_runs(self.dst, self.src, self.w, self.n)
        if self.runs_cp is None:
            self.runs_cp = monoids.arc_runs(self.src, self.dst, self.w, self.n)

    @property
    def n(self) -> int:
        return self.n_static

    def gather_rows(self, sources: torch.Tensor) -> torch.Tensor:
        return _gather_rows_scatter(self.src, self.dst, self.w, self.n,
                                    sources)

    def relax_mp(self, F: Multpath) -> Multpath:
        return monoids.multpath_relax_coo(F, self.src, self.dst, self.w,
                                          self.n, runs=self.runs_mp)

    def relax_cp(self, F: Centpath) -> Centpath:
        return monoids.centpath_relax_coo(F, self.src, self.dst, self.w,
                                          self.n, runs=self.runs_cp)

    def count_sp_children(self, Tw: torch.Tensor) -> torch.Tensor:
        return monoids.count_sp_children_coo(Tw, self.src, self.dst, self.w,
                                             self.n)


def _frontier_counts(mask: torch.Tensor, indptr: torch.Tensor
                     ) -> torch.Tensor:
    """(union-frontier columns, their incident arcs) as a (2,) int64
    tensor on the device: what the bucket pick reads."""
    colmask = mask.any(dim=0)
    deg = indptr[1:] - indptr[:-1]
    return torch.stack([colmask.sum(), torch.where(colmask, deg, 0).sum()])


@dataclasses.dataclass
class CsrAdj:
    """Dual-sorted arc lists with frontier-compacted relaxations.

    The same arcs are carried twice: sorted by src with row pointers
    (``indptr``/``src``/``dst``/``w``; as COO they are the overflow
    fallback, ``coo``) and sorted by dst (``indptr_in``/``src_in``/
    ``w_in``, the CSC side MFBr's backward action expands). ``caps`` is the
    power-of-two capacity ladder ``((vcap, ecap), ...)``: each relax takes
    the *union-column* frontier (vertices active in any batch row) and its
    incident arcs, runs the smallest bucket that fits, and falls back to
    the full-edge-list COO relax when every bucket overflows. Results never
    depend on the ladder, only the work does.
    """

    indptr: torch.Tensor  # (n+1,) int64 row pointers into the by-src arrays
    src: torch.Tensor  # (E,) int64, sorted ascending
    dst: torch.Tensor  # (E,) int64
    w: torch.Tensor  # (E,) float32, padding = inf
    indptr_in: torch.Tensor  # (n+1,) int64 row pointers into the by-dst arrays
    src_in: torch.Tensor  # (E,) int64 — predecessor of each in-arc
    w_in: torch.Tensor  # (E,) float32
    n_static: int
    caps: Tuple[Tuple[int, int], ...]
    coo: Optional[CooAdj] = None  # the by-src arcs: fallback, child count

    def __post_init__(self):
        if self.coo is None:
            self.coo = CooAdj(self.src, self.dst, self.w, self.n_static)

    @property
    def n(self) -> int:
        return self.n_static

    def gather_rows(self, sources: torch.Tensor) -> torch.Tensor:
        return self.coo.gather_rows(sources)

    def _pick_bucket(self, nnz: int, arcs: int) -> int:
        """The smallest bucket that fits, ``len(caps)`` if none does."""
        for i, (vcap, ecap) in enumerate(self.caps):
            if nnz <= vcap and arcs <= ecap:
                return i
        return len(self.caps)

    @staticmethod
    def _read_counts(counts: torch.Tensor) -> list:
        tracing.count("host_syncs")
        return counts.tolist()

    def _span(self, F, nnz: int, arcs: int, bucket: int, outputs: int):
        """The ``csr.relax`` span of one relax: its live arcs and the
        frontier columns it reads, the whole arc list and every column on
        the fallback."""
        fallback = bucket == len(self.caps)
        return tracing.span(
            "csr.relax", F.w.device, rows=F.w.shape[0], n=self.n,
            live_arcs=self.src.shape[0] if fallback else int(arcs),
            cols=self.n if fallback else int(nnz), outputs=outputs,
            bucket=bucket)

    def frontier_counts_mp(self, F: Multpath) -> torch.Tensor:
        return _frontier_counts(torch.isfinite(F.w), self.indptr)

    def frontier_counts_cp(self, F: Centpath) -> torch.Tensor:
        return _frontier_counts(torch.isfinite(F.w), self.indptr_in)

    def relax_mp_stats(self, F: Multpath, counts: Optional[Sequence[int]]
                       = None) -> Tuple[Multpath, RelaxStats]:
        """``counts``: ``frontier_counts_mp(F)`` already read to the host;
        read here (one sync) when omitted."""
        nnz, arcs = (counts if counts is not None
                     else self._read_counts(self.frontier_counts_mp(F)))
        bucket = self._pick_bucket(nnz, arcs)
        with self._span(F, nnz, arcs, bucket, outputs=2):
            if bucket < len(self.caps):
                vcap, ecap = self.caps[bucket]
                out = monoids.multpath_relax_csr(F, self.indptr, self.dst,
                                                 self.w, self.n, vcap=vcap,
                                                 ecap=ecap)
            else:
                out = self.coo.relax_mp(F)
        overflow = int(bucket == len(self.caps))
        return out, RelaxStats(int(nnz), int(arcs), bucket, overflow)

    def relax_cp_stats(self, F: Centpath, counts: Optional[Sequence[int]]
                       = None) -> Tuple[Centpath, RelaxStats]:
        nnz, arcs = (counts if counts is not None
                     else self._read_counts(self.frontier_counts_cp(F)))
        bucket = self._pick_bucket(nnz, arcs)
        with self._span(F, nnz, arcs, bucket, outputs=3):
            if bucket < len(self.caps):
                vcap, ecap = self.caps[bucket]
                out = monoids.centpath_relax_csr(F, self.indptr_in,
                                                 self.src_in, self.w_in,
                                                 self.n, vcap=vcap, ecap=ecap)
            else:
                out = self.coo.relax_cp(F)
        overflow = int(bucket == len(self.caps))
        return out, RelaxStats(int(nnz), int(arcs), bucket, overflow)

    def relax_mp(self, F: Multpath) -> Multpath:
        return self.relax_mp_stats(F)[0]

    def relax_cp(self, F: Centpath) -> Centpath:
        return self.relax_cp_stats(F)[0]

    def count_sp_children(self, Tw: torch.Tensor) -> torch.Tensor:
        return self.coo.count_sp_children(Tw)


def frontier_caps(n_b: int, n: int, m: int) -> Tuple[Tuple[int, int], ...]:
    """Power-of-two ``(vcap, ecap)`` escalation ladder for compaction.

    ``vcap`` bounds the compacted union-frontier *columns*, ``ecap`` their
    incident arc slots. A compact relax costs ``n_b * ecap`` candidate
    work plus an O(n) compaction, against ``n_b * m`` for the full COO
    fallback, so the ladder's ecaps climb by powers of two from ~m/32 and
    stop short of ``m``, letting the fallback absorb saturated frontiers.
    ``vcap = n`` on every rung: only arc volume escalates.
    """
    full_e = max(m, 1)
    caps = []
    e = 2
    while e < max(full_e // 32, 2):
        e *= 2
    while e < full_e and len(caps) < 4:
        caps.append((int(n), int(e)))
        e *= 4
    if not caps:
        caps.append((int(n), int(full_e)))
    return tuple(caps)


def dense_adj_from_graph(g: Graph, *, block: int = 512,
                         device="cuda") -> DenseAdj:
    dev = resolve_device(device)
    return DenseAdj(torch.from_numpy(coo_to_dense(g)).to(dev), block=block)


def dense_adj_from_arrays(a: np.ndarray, at: Optional[np.ndarray] = None, *,
                          block: int = 512, device="cuda") -> DenseAdj:
    """A ``DenseAdj`` from host arrays, e.g. ``np.asarray(ref_adj.a)`` and
    ``np.asarray(ref_adj.at)`` of the reference container, so both packages
    relax the same matrix."""
    dev = resolve_device(device)

    def put(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)

    return DenseAdj(put(a), None if at is None else put(at), block)


def _index(x, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.int64), device=dev)


def _weights(x, dev) -> torch.Tensor:
    return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)


def coo_adj_from_arrays(src: np.ndarray, dst: np.ndarray, w: np.ndarray,
                        n: int, *, device="cuda") -> CooAdj:
    """A ``CooAdj`` from host arrays, e.g. those of the reference's
    ``CooAdj``, so both packages relax the same arcs in the same order."""
    dev = resolve_device(device)
    return CooAdj(_index(src, dev), _index(dst, dev), _weights(w, dev),
                  int(n))


def coo_adj_from_graph(g: Graph, *, pad_multiple: int = 128,
                       device="cuda") -> CooAdj:
    src, dst, w = pad_edges(g, multiple=pad_multiple)
    return coo_adj_from_arrays(src, dst, w, g.n, device=device)


def csr_adj_from_arrays(indptr, src, dst, w, indptr_in, src_in, w_in, *,
                        n: int, caps: Sequence[Tuple[int, int]],
                        device="cuda") -> CsrAdj:
    """A ``CsrAdj`` from host arrays, e.g. those of the reference's
    ``CsrAdj`` (with its ``n`` and ``caps``)."""
    dev = resolve_device(device)
    return CsrAdj(_index(indptr, dev), _index(src, dev), _index(dst, dev),
                  _weights(w, dev), _index(indptr_in, dev),
                  _index(src_in, dev), _weights(w_in, dev), int(n),
                  tuple((int(v), int(e)) for v, e in caps))


def csr_adj_from_graph(g: Graph, *, n_b: int = 64,
                       caps: Optional[Sequence[Tuple[int, int]]] = None,
                       pad_multiple: int = 1, device="cuda") -> CsrAdj:
    """Build the dual-sorted container on the host (stable sorts).

    ``n_b`` sizes the default capacity ladder (``frontier_caps``); explicit
    ``caps`` override it — tests force escalation with ``((1, 1),)``.
    """
    src, dst, w = pad_edges(g, multiple=pad_multiple)
    order = np.argsort(src, kind="stable")
    src_s, dst_s, w_s = src[order], dst[order], w[order]
    order_in = np.argsort(dst, kind="stable")
    src_in, w_in = src[order_in], w[order_in]
    indptr, indptr_in = (np.concatenate([[0], np.cumsum(np.bincount(
        x, minlength=g.n))]) for x in (src, dst))
    if caps is None:
        caps = frontier_caps(n_b, g.n, int(src_s.shape[0]))
    return csr_adj_from_arrays(indptr, src_s, dst_s, w_s, indptr_in, src_in,
                               w_in, n=g.n, caps=caps, device=device)
