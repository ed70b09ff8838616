"""Multpath / centpath monoid algebra (paper Sections 3, 4.1.1, 4.2.1).

A *multpath* is a tuple ``(w, m)``: path weight + multiplicity. The monoid
``(M, ⊕)`` keeps the smaller weight and sums multiplicities on ties. The
Bellman-Ford *action* is ``f((w, m), a) = (w + a, m)``.

A *centpath* is a tuple ``(w, p, c)``: weight + partial centrality factor +
counter. The monoid ``(C, ⊗)`` keeps the **larger** weight and sums ``p``
and ``c`` on ties. The Brandes action is ``g((w, p, c), a) = (w - a, p, c)``.

Frontiers are dense in structure and sparse in value. A multpath entry is
*inactive* when ``(w, m) = (inf, 0)``; a centpath entry is inactive when
``w = -inf``. They are masked explicitly, because IEEE ``inf - a = inf``
would otherwise win the centpath max-selection.

Three relaxation regimes for each action:

* ``*_relax_dense`` — a blocked generalized matmul against a dense
  ``(n, n)`` adjacency (``inf`` off-structure), ``C(i,j) = ⊕_k f(T(i,k),
  A(k,j))``, swept over k-blocks in a Python loop so the ``(nb, bk, n)``
  candidate block stays bounded. It is the plain PyTorch version of the
  two product kernels in ``repro_torch.kernels``.
* ``*_relax_coo`` — edge-list relaxation over the arcs grouped into runs
  by the segment they reduce into (``Runs``): the gather of F, the per-run
  min/max and the tie sums, in one call of
  ``repro_torch.kernels.segment_relax`` — on the card the Hopper kernel
  ``segment_relax.cu``, which never builds an ``(nb, E)`` operand; on the
  host its plain version (``index_select``, ``scatter_reduce_`` amin/amax
  over a 1-D index expanded as a view, and CPU ``index_add_``).
* ``*_relax_csr`` — frontier-compacted relaxation: the union-frontier
  columns compact into ``vcap`` slots, only their incident CSR arc ranges
  expand into ``ecap`` arc slots, grouped into runs by a stable sort, and
  reduce through the same call, so per-iteration work tracks the maximal
  frontier.

The segment sums add each segment's ties in ascending arc order
(``arc_runs`` groups the arcs by a stable sort), the order of the
reference's ``jax.ops.segment_sum`` on the CPU: so the compacted relax
equals its COO fallback bitwise (the fallback only adds exact zeros), and
a row's sums do not depend on the other rows of its batch.

Equality of float path weights is exact (paper assumes exact arithmetic;
integer-valued float32 weights are exact up to 2**24).
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from repro_torch import tracing
from repro_torch.kernels.segment_relax import (centpath_segment_relax,
                                               multpath_segment_relax)

INF = float("inf")


class Multpath(NamedTuple):
    w: torch.Tensor  # weights, inactive = +inf
    m: torch.Tensor  # multiplicities, inactive = 0


class Centpath(NamedTuple):
    w: torch.Tensor  # weights, inactive = -inf
    p: torch.Tensor  # partial centrality factor
    c: torch.Tensor  # counter (number of contributing children on ties)


def multpath_identity(shape, *, dtype=torch.float32, device=None) -> Multpath:
    return Multpath(torch.full(shape, INF, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))


def centpath_identity(shape, *, dtype=torch.float32, device=None) -> Centpath:
    return Centpath(torch.full(shape, -INF, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))


def multpath_combine(x: Multpath, y: Multpath) -> Multpath:
    """Elementwise ⊕: min weight, sum multiplicities on exact ties."""
    w = torch.minimum(x.w, y.w)
    tie = (x.w == y.w) & torch.isfinite(x.w)
    m = torch.where(x.w < y.w, x.m, torch.where(tie, x.m + y.m, y.m))
    return Multpath(w, m)


def centpath_combine(x: Centpath, y: Centpath) -> Centpath:
    """Elementwise ⊗: max weight, sum p and c on exact ties."""
    w = torch.maximum(x.w, y.w)
    tie = (x.w == y.w) & torch.isfinite(x.w)
    p = torch.where(x.w > y.w, x.p, torch.where(tie, x.p + y.p, y.p))
    c = torch.where(x.w > y.w, x.c, torch.where(tie, x.c + y.c, y.c))
    return Centpath(w, p, c)


def _mp_block(Fw, Fm, Ablk):
    """min-plus with multiplicities over one k-block.

    Fw, Fm: (nb, bk); Ablk: (bk, n) -> (nb, n) pair.
    """
    cand = Fw[:, :, None] + Ablk[None, :, :]  # (nb, bk, n); inf + x = inf
    w = cand.amin(dim=1)
    tie = (cand == w[:, None, :]) & torch.isfinite(cand)
    m = torch.where(tie, Fm[:, :, None], 0.0).sum(dim=1)
    return w, m


def multpath_relax_dense(F: Multpath, A: torch.Tensor, *,
                         block: int = 256) -> Multpath:
    """``C = F •_(⊕,f) A``: C(s,v) = ⊕_u f(F(s,u), A(u,v)).

    F.w/F.m: (nb, k); A: (k, n_out) with inf off-structure. Returns
    (nb, n_out), swept over ``block``-wide slices of the contraction dim.
    """
    nb, k = F.w.shape
    acc = multpath_identity((nb, A.shape[1]), dtype=F.w.dtype,
                            device=F.w.device)
    for k0 in range(0, k, block):
        w, m = _mp_block(F.w[:, k0:k0 + block], F.m[:, k0:k0 + block],
                         A[k0:k0 + block])
        acc = multpath_combine(acc, Multpath(w, m))
    return acc


def _cp_block(Fw, Fp, Bblk):
    """max-select with p/c tie sums over one k-block.

    Fw, Fp: (nb, bk); Bblk: (bk, n). Inactive F entries carry w = -inf.
    cand(s, v) = F.w(s, u) - B(u, v); inactive or no-edge -> -inf.
    """
    cand = Fw[:, :, None] - Bblk[None, :, :]
    cand = torch.where(torch.isfinite(Fw)[:, :, None]
                       & torch.isfinite(Bblk)[None, :, :], cand, -INF)
    w = cand.amax(dim=1)
    tie = (cand == w[:, None, :]) & torch.isfinite(cand)
    p = torch.where(tie, Fp[:, :, None], 0.0).sum(dim=1)
    c = tie.sum(dim=1, dtype=Fw.dtype)
    return w, p, c


def centpath_relax_dense(F: Centpath, B: torch.Tensor, *,
                         block: int = 256) -> Centpath:
    """``C = F •_(⊗,g) B`` with contraction over B's first axis.

    For the Brandes step the caller passes ``B = A.T`` so that
    ``C(s, v) = ⊗_u g(F(s, u), A(v, u))`` — contributions flow from
    SP-DAG children ``u`` back to predecessors ``v``.
    """
    nb, k = F.w.shape
    acc = centpath_identity((nb, B.shape[1]), dtype=F.w.dtype,
                            device=F.w.device)
    for k0 in range(0, k, block):
        w, p, c = _cp_block(F.w[:, k0:k0 + block], F.p[:, k0:k0 + block],
                            B[k0:k0 + block])
        acc = centpath_combine(acc, Centpath(w, p, c))
    return acc


def count_sp_children_dense(Tw: torch.Tensor, A: torch.Tensor, *,
                            block: int = 256) -> torch.Tensor:
    """c0(s, v) = #{u : T(s,v).w + A(v,u) == T(s,u).w, both finite}.

    The number of shortest-path-DAG children of v (vertices whose shortest
    path's last hop leaves v), as int32. Blocked over v's out-neighborhood.
    """
    nb, n = Tw.shape
    acc = torch.zeros((nb, n), dtype=torch.int32, device=Tw.device)
    for u0 in range(0, n, block):
        # cand(s, v, u) = Tw(s, v) + A(v, u)
        cand = Tw[:, :, None] + A[None, :, u0:u0 + block]
        hit = (cand == Tw[:, None, u0:u0 + block]) & torch.isfinite(cand)
        acc += hit.sum(dim=2, dtype=torch.int32)
    return acc


# ---------------------------------------------------------------------------
# COO (sparse) regime: segment-op relaxations in the (nb, E) layout.
# ---------------------------------------------------------------------------


class Runs(NamedTuple):
    """Arcs grouped into runs by the segment each one reduces into.

    ``seg`` is ascending, from a stable sort, so inside a run the arcs keep
    their order; ``col`` is the frontier column each arc reads, ``w`` its
    weight, ``offsets`` (n+1,) the run bounds. Arcs with ``seg == n`` lie
    past ``offsets[n]`` and reduce into no segment (dead slots).
    """

    col: torch.Tensor  # (L,) int64
    seg: torch.Tensor  # (L,) int64, ascending, in [0, n]
    w: torch.Tensor  # (L,) float32
    offsets: torch.Tensor  # (n + 1,) int64


def arc_runs(seg: torch.Tensor, col: torch.Tensor, w: torch.Tensor,
             n: int) -> Runs:
    """Group arcs by ``seg`` (a stable sort: ties keep their index order)."""
    seg_s, order = torch.sort(seg, stable=True)
    offsets = torch.searchsorted(
        seg_s, torch.arange(n + 1, dtype=seg_s.dtype, device=seg_s.device))
    return Runs(col[order], seg_s, w[order], offsets)


def _multpath_relax_runs(F: Multpath, r: Runs) -> Multpath:
    return Multpath(*multpath_segment_relax(F.w, F.m, r.col, r.seg, r.w,
                                            r.offsets))


def _centpath_relax_runs(F: Centpath, r: Runs) -> Centpath:
    return Centpath(*centpath_segment_relax(F.w, F.p, r.col, r.seg, r.w,
                                            r.offsets))


def multpath_relax_coo(F: Multpath, src: torch.Tensor, dst: torch.Tensor,
                       w: torch.Tensor, n: int, *,
                       runs: Runs = None) -> Multpath:
    """Edge-list version of ``multpath_relax_dense``.

    src/dst/w: (E,) padded COO arcs (padding arcs carry w = inf).
    F.w/F.m: (nb, n). ``runs``: the arcs already grouped by ``dst``
    (``arc_runs(dst, src, w, n)``, what ``CooAdj`` keeps); grouped here
    when omitted. Multiplicities sum over each ``dst`` in arc order.
    """
    return _multpath_relax_runs(
        F, runs if runs is not None else arc_runs(dst, src, w, n))


def centpath_relax_coo(F: Centpath, src: torch.Tensor, dst: torch.Tensor,
                       w: torch.Tensor, n: int, *,
                       runs: Runs = None) -> Centpath:
    """Edge-list Brandes action: contributions flow dst -> src.

    For arc (v -> u, a): cand(s, v) over children u: F.w(s, u) - a,
    reduced over ``src`` (the predecessor side). ``runs``: the arcs
    grouped by ``src`` (``arc_runs(src, dst, w, n)``).
    """
    return _centpath_relax_runs(
        F, runs if runs is not None else arc_runs(src, dst, w, n))


def count_sp_children_coo(Tw: torch.Tensor, src: torch.Tensor,
                          dst: torch.Tensor, w: torch.Tensor,
                          n: int) -> torch.Tensor:
    """COO version of ``count_sp_children_dense``: int32 counts summed over
    ``src`` (integer adds are exact in any order)."""
    cand = Tw.index_select(1, src) + w  # (nb, E)
    hit = (cand == Tw.index_select(1, dst)) & torch.isfinite(cand)
    out = torch.zeros((Tw.shape[0], n), dtype=torch.int32, device=Tw.device)
    return out.index_add_(1, src, hit.to(torch.int32))


# ---------------------------------------------------------------------------
# Frontier-compacted CSR regime: work tracks the maximal frontier.
# ---------------------------------------------------------------------------


def _compact_cols(mask: torch.Tensor, indptr: torch.Tensor, vcap: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Compact the frontier's active *columns* into ``vcap`` slots.

    mask: (nb, n) bool frontier occupancy; a column is active when any
    batch row holds it (the union frontier). Returns (u, offs): per-slot
    vertex id (0 past the population) and the inclusive cumsum of the
    per-slot arc degrees (``offs[-1]`` = total incident arcs). Slots past
    the population carry degree 0, so they own no arc range. The first
    ``vcap`` active columns are taken in ascending order, as
    ``jnp.nonzero(..., size=vcap, fill_value=n)`` does, without a host
    sync: each column's rank goes by a cumsum, the rest to a dump slot.
    """
    n = mask.shape[1]
    colmask = mask.any(dim=0)
    rank = torch.cumsum(colmask, 0) - 1
    keep = colmask & (rank < vcap)
    cols = torch.full((vcap + 1,), n, dtype=torch.int64, device=mask.device)
    cols.scatter_(0, torch.where(keep, rank, vcap),
                  torch.arange(n, device=mask.device))
    cols = cols[:vcap]
    valid = cols < n
    u = torch.where(valid, cols, 0)
    deg = torch.where(valid, indptr[u + 1] - indptr[u], 0)
    return u, torch.cumsum(deg, 0)


def _expand_edges(u: torch.Tensor, offs: torch.Tensor, indptr: torch.Tensor,
                  ecap: int):
    """Expand compacted slots into ``ecap`` load-balanced arc slots.

    Owner assignment is a scatter of each populated slot's start offset
    followed by a cumulative max — two linear passes over ``ecap``, no
    per-arc binary search. Returns (owner, arc_id, live); dead slots
    (``pos >= offs[-1]``) are masked.
    """
    dev = u.device
    pos = torch.arange(ecap, dtype=offs.dtype, device=dev)
    starts = torch.cat([offs.new_zeros(1), offs[:-1]])
    slots = torch.arange(u.shape[0], dtype=torch.int64, device=dev)
    # Degree-0 slots share a start with their successor; dropping them
    # keeps the cummax from handing their (empty) range to the wrong
    # owner. Starts past ecap go to slot ecap, which is dropped (the
    # reference's mode="drop").
    tgt = torch.where((offs > starts) & (starts < ecap), starts, ecap)
    owner = torch.zeros(ecap + 1, dtype=torch.int64, device=dev)
    owner.scatter_reduce_(0, tgt, slots, "amax", include_self=True)
    j = torch.cummax(owner[:ecap], 0).values
    live = pos < offs[-1]
    eid = torch.where(live, indptr[u[j]] + (pos - starts[j]), 0)
    return j, eid, live


def csr_runs(Fw: torch.Tensor, indptr: torch.Tensor, seg: torch.Tensor,
             w: torch.Tensor, n: int, *, vcap: int, ecap: int) -> Runs:
    """The union frontier's incident arcs, grouped into runs by ``seg``.

    The columns active in any row of ``Fw`` compact into ``vcap`` slots,
    their ``indptr`` arc ranges expand into ``ecap`` arc slots, and each
    arc reads its slot's column. Dead slots and padding arcs (w = inf,
    which never reach a tie) go to segment n, past ``offsets[n]``. A
    ``csr.runs`` span of ``repro_torch.tracing``.
    """
    with tracing.span("csr.runs", Fw.device):
        u, offs = _compact_cols(torch.isfinite(Fw), indptr, vcap)
        j, eid, live = _expand_edges(u, offs, indptr, ecap)
        wa = w[eid]
        alive = live & torch.isfinite(wa)
        return arc_runs(torch.where(alive, seg[eid], n), u[j],
                        torch.where(alive, wa, INF), n)


def multpath_relax_csr(F: Multpath, indptr: torch.Tensor, dst: torch.Tensor,
                       w: torch.Tensor, n: int, *, vcap: int, ecap: int
                       ) -> Multpath:
    """Frontier-compacted ``multpath_relax_coo`` over by-src CSR arcs.

    Only arcs leaving the union frontier are touched. The result is
    exactly ``multpath_relax_coo`` over the same by-src arcs *provided*
    the frontier fits (active columns <= vcap, incident arcs <= ecap),
    which ``CsrAdj`` guarantees by its bucket pick: arcs from inactive
    columns hold F.w = inf in every batch row and can never tie.
    """
    return _multpath_relax_runs(
        F, csr_runs(F.w, indptr, dst, w, n, vcap=vcap, ecap=ecap))


def centpath_relax_csr(F: Centpath, indptr_in: torch.Tensor,
                       src_in: torch.Tensor, w_in: torch.Tensor, n: int, *,
                       vcap: int, ecap: int) -> Centpath:
    """Frontier-compacted ``centpath_relax_coo`` over by-dst (CSC) arcs.

    The active side of the Brandes action is the *child* (the arc's dst):
    active child columns compact into slots, each child's in-arc range
    expands, and the candidates reduce to the predecessor side. Equals
    ``centpath_relax_coo`` under the same capacity proviso.
    """
    return _centpath_relax_runs(
        F, csr_runs(F.w, indptr_in, src_in, w_in, n, vcap=vcap, ecap=ecap))
