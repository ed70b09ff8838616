"""MFBC — combined betweenness centrality driver (paper Algorithm 3).

``λ(v) = Σ_s ζ(s, v) · σ̄(s, v)`` accumulated over ``⌈n / n_b⌉`` source
batches. Each batch runs MFBF, the t = s self-mask and MFBr on the device;
the batch loop and the float64 λ accumulator live on the host.

Entry points: the exact sweep (``mfbc``, ``mfbc_batch``), the sampled
path's moments (``mfbc_batch_moments``, ``mfbc_batch_moments_segmented``),
the traced moments (``mfbc_batch_moments_traced``) and their
metric-generic forms (``metric_batch_moments``,
``metric_batch_moments_segmented``), on the dense, COO and CSR backends.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import mfbf as _mfbf
from repro_torch.core import mfbr as _mfbr
from repro_torch.core.adjacency import (coo_adj_from_graph,
                                        csr_adj_from_graph,
                                        dense_adj_from_graph)
from repro_torch.core.monoids import INF, Multpath
from repro_torch.graphs.formats import Graph


def _batch_contrib(adj, sources: torch.Tensor, valid: torch.Tensor, *,
                   iterate: str = "while", max_iters_bf: int = 0,
                   max_iters_br: int = 0, trace: bool = False):
    """Shared Algorithm 3 batch body: per-source contributions δ_s(v).

    Returns (contrib, mask, Tw, Tm, traces) with contrib (nb, n) zeroed on
    unreachable/padding entries; ``traces`` is the (MFBF, MFBr)
    ``SweepTrace`` pair with ``trace=True`` (the sweeps then run their
    while loops), else None.
    """
    traces = None
    if trace:
        Tw, Tm, tr_bf = _mfbf.mfbf(adj, sources, max_iters=max_iters_bf,
                                   trace=True)
    else:
        Tw, Tm = _mfbf.mfbf(adj, sources, iterate=iterate,
                            max_iters=max_iters_bf)
    # Exclude the t = s destination (σ(s, t, v) = 0 when t = s): mask the
    # source's own column to (∞, 1) — the 1 keeps reciprocals safe. Tw and
    # Tm are fresh tensors of this batch, so they are written in place.
    rows = torch.arange(sources.shape[0], device=Tw.device)
    Tw[rows, sources.long()] = INF
    Tm[rows, sources.long()] = 1.0
    if trace:
        Zp, tr_br = _mfbr.mfbr(adj, Tw, Tm, max_iters=max_iters_br,
                               trace=True)
        traces = (tr_bf, tr_br)
    else:
        Zp = _mfbr.mfbr(adj, Tw, Tm, iterate=iterate, max_iters=max_iters_br)
    mask = torch.isfinite(Tw) & valid[:, None]
    contrib = torch.where(mask, Zp * Tm, 0.0)
    return contrib, mask, Tw, Tm, traces


def mfbc_batch(adj, sources: torch.Tensor, valid: torch.Tensor, *,
               iterate: str = "while", max_iters_bf: int = 0,
               max_iters_br: int = 0
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One batch of Algorithm 3: returns (λ_partial, Tw, Tm).

    valid: (nb,) bool — False for padding sources (contribute nothing).
    """
    contrib, _, Tw, Tm, _ = _batch_contrib(
        adj, sources, valid, iterate=iterate, max_iters_bf=max_iters_bf,
        max_iters_br=max_iters_br)
    return contrib.sum(dim=0), Tw, Tm


def mfbc_batch_moments(adj, sources: torch.Tensor, valid: torch.Tensor, *,
                       iterate: str = "while", max_iters_bf: int = 0,
                       max_iters_br: int = 0
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One Algorithm 3 batch returning per-vertex dependency moments.

    Returns (S1, S2, n_reach) where, over the batch's valid sources s,
    ``S1(v) = Σ_s δ_s(v)``, ``S2(v) = Σ_s δ_s(v)²`` and
    ``n_reach(v) = Σ_s [v reachable from s]`` (int32). S1 is
    ``mfbc_batch``'s λ_partial with the rows added in row order (``_rows``);
    S2 feeds the confidence intervals of the sampled estimator
    (``repro_torch.approx``).
    """
    contrib, mask, _, _, _ = _batch_contrib(
        adj, sources, valid, iterate=iterate, max_iters_bf=max_iters_bf,
        max_iters_br=max_iters_br)
    return _rows(contrib, mask)


def mfbc_batch_moments_traced(adj, sources: torch.Tensor,
                              valid: torch.Tensor, *, max_iters_bf: int = 0,
                              max_iters_br: int = 0):
    """``mfbc_batch_moments`` plus the per-iteration occupancy traces.

    Returns (S1, S2, n_reach, trace_bf, trace_br), the traces being the
    ``repro_torch.core.mfbf.SweepTrace`` of the forward (MFBF) and backward
    (MFBr) sweeps. The moments come from the same relaxation sequence as
    the untraced while loop, so they are bitwise unchanged.
    """
    contrib, mask, _, _, (tr_bf, tr_br) = _batch_contrib(
        adj, sources, valid, max_iters_bf=max_iters_bf,
        max_iters_br=max_iters_br, trace=True)
    return (*_rows(contrib, mask), tr_bf, tr_br)


def segment_fold(x: torch.Tensor, slot_ids: np.ndarray,
                 n_slots: int) -> torch.Tensor:
    """Per-slot sums of the rows of ``x``: ``out[j] = Σ x[r]`` over the
    rows r with ``slot_ids[r] == j``, added one row at a time in row order.

    Rows tagged ``n_slots`` (padding) go to a dump row that is dropped.
    Step i adds every slot's i-th row at once; a slot appears at most once
    per step, so each output element takes exactly one add per step: no
    atomics and no reduction tree whose pairing would follow the batch
    size. A slot's sums are therefore bitwise those of its rows alone, in
    any batch and on either device. ``slot_ids`` is on the host, where the
    fold is scheduled; at most ``len(x)`` steps of a few launches each.
    """
    slot_ids = np.asarray(slot_ids, np.int64)
    if slot_ids.shape != x.shape[:1] or (
            slot_ids.size and not 0 <= slot_ids.min() <= slot_ids.max()
            <= n_slots):
        raise ValueError(f"slot_ids must tag each of the {x.shape[0]} rows "
                         f"with a slot in [0, {n_slots}]")
    rank = np.zeros(slot_ids.shape[0], np.int64)
    seen = {}
    for r, sid in enumerate(slot_ids.tolist()):
        rank[r] = seen.get(sid, 0)
        seen[sid] = rank[r] + 1
    order = np.argsort(rank, kind="stable")  # rows grouped by step
    bounds = np.searchsorted(rank[order], np.arange(int(rank.max(initial=-1))
                                                    + 2))
    rows = torch.from_numpy(order).to(x.device)
    segs = torch.from_numpy(slot_ids[order]).to(x.device)
    out = torch.zeros((n_slots + 1,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    for lo, hi in zip(bounds[:-1].tolist(), bounds[1:].tolist()):
        seg = segs[lo:hi]
        out.index_copy_(0, seg, out.index_select(0, seg)
                        + x.index_select(0, rows[lo:hi]))
    return out[:n_slots]


def mfbc_batch_moments_segmented(adj, sources: torch.Tensor,
                                 valid: torch.Tensor, slot_ids: np.ndarray,
                                 *, n_slots: int, iterate: str = "while",
                                 max_iters_bf: int = 0, max_iters_br: int = 0
                                 ) -> Tuple[torch.Tensor, torch.Tensor,
                                            torch.Tensor]:
    """One Algorithm 3 batch, moments summed per request slot.

    The cross-request fusion primitive: a fused batch packs sources of
    several concurrent queries, tagged per row with ``slot_ids[s] ∈
    [0, n_slots)`` (host array; padding rows carry ``n_slots``, a dump
    segment that is dropped). Returns (S1, S2, n_reach), each
    ``(n_slots, n)``, where row j holds what this function returns for
    slot j's rows alone: ``segment_fold`` adds each slot's rows in row
    order, and on the card the adjacency's fixed split count
    (``DenseAdj.for_batches``) keeps every row's contribution independent
    of the batch size.
    """
    contrib, mask, _, _, _ = _batch_contrib(
        adj, sources, valid, iterate=iterate, max_iters_bf=max_iters_bf,
        max_iters_br=max_iters_br)
    return _fold_moments(contrib, mask, slot_ids, n_slots)


def _fold_moments(contrib: torch.Tensor, mask: torch.Tensor,
                  slot_ids: np.ndarray, n_slots: int):
    """Per-slot (Σδ, Σδ², n_reach) of a batch's contributions."""
    # one fold for the three fields; counts below 2²⁴ are exact in float32
    folded = segment_fold(torch.stack(
        [contrib, contrib * contrib, mask.to(contrib.dtype)], dim=1),
        slot_ids, n_slots)
    return folded[:, 0], folded[:, 1], folded[:, 2].to(torch.int32)


def _rows(contrib: torch.Tensor, mask: torch.Tensor):
    """(Σδ, Σδ², n_reach) of a whole batch, its rows added in row order:
    ``_fold_moments`` with every row in one slot. A batch's statistics are
    then bitwise what the segmented step gives the same rows as a slot, so
    a request served alone (``step``) equals it served fused
    (``step_segmented``). Padding rows add zeros."""
    s1, s2, nr = _fold_moments(contrib, mask,
                               np.zeros(contrib.shape[0], np.int64), 1)
    return s1[0], s2[0], nr[0]


# ==========================================================================
# Metric-generic batch bodies (the MetricSpec sweep substrate).
#
# Every sampled metric shares MFBF's forward sweep and the t = s self-mask;
# they differ only in the final elementwise contribution formula (and, for
# betweenness, the extra MFBr backward sweep). ``kinds`` is the tuple of
# metric names present in the batch and ``metric_ids`` tags each row with
# an index into it, so a fused batch mixes metrics row-wise over one relax
# sequence. The default path keeps calling the betweenness functions above.
# ==========================================================================


def _bounded_mfbf(adj, sources: torch.Tensor, *, hops: int):
    """MFBF stopped after ``hops - 1`` iterations (Lemma 4.1: T is then
    exactly the ≤ ``hops``-edge shortest paths; finiteness is hop-bounded
    reachability). ``hops=1`` runs none: T is the direct-edge row gather.

    One host read before each iteration: the frontier's population (an
    empty frontier ends the loop early, which changes no value) and, on a
    ``CsrAdj``, the counts its relax picks a bucket from, in the same copy.
    """
    Tw0 = adj.gather_rows(sources)
    T = F = Multpath(Tw0, torch.isfinite(Tw0).to(Tw0.dtype))
    probe = getattr(adj, "frontier_counts_mp", None)
    count = _mfbf._frontier_active(F).sum()
    for _ in range(hops - 1):
        nact, hint = _mfbf.read_counts(count, F, probe)
        if nact == 0:
            break
        T, F, count, _ = _mfbf._step(adj, T, F, hint)
    return T.w, T.m


def _metric_contrib(adj, sources: torch.Tensor, valid: torch.Tensor,
                    metric_ids: torch.Tensor, *, kinds, hops: int,
                    iterate: str, max_iters_bf: int, max_iters_br: int):
    """Metric-generic Algorithm 3 batch body: (contrib, mask).

    kinds: tuple of metric names; rows select theirs via ``metric_ids``.
    Bounded (khop) and unbounded sweeps never mix — the serving layer
    groups fusion by ``core.metrics.fuse_group``.
    """
    if "khop" in kinds:
        if not all(k == "khop" for k in kinds):
            raise ValueError("hop-bounded sweeps cannot fuse with "
                             f"unbounded metrics: {kinds}")
        if hops < 1:
            raise ValueError(f"khop requires hops >= 1, got {hops}")
        Tw, Tm = _bounded_mfbf(adj, sources, hops=hops)
    else:
        Tw, Tm = _mfbf.mfbf(adj, sources, iterate=iterate,
                            max_iters=max_iters_bf)
    rows = torch.arange(sources.shape[0], device=Tw.device)
    Tw[rows, sources.long()] = INF
    Tm[rows, sources.long()] = 1.0
    mask = torch.isfinite(Tw) & valid[:, None]
    Zp = None
    if "betweenness" in kinds:
        Zp = _mfbr.mfbr(adj, Tw, Tm, iterate=iterate, max_iters=max_iters_br)

    def one(kind):
        if kind == "betweenness":
            return Zp * Tm
        if kind == "closeness":
            return Tw  # farness: δ_s(v) = τ(s, v) where finite
        if kind == "khop":
            return torch.ones_like(Tw)  # reach indicator within the bound
        raise ValueError(f"metric {kind!r} has no sampled batch body")

    contrib = one(kinds[0])
    for i, kind in enumerate(kinds[1:], start=1):
        contrib = torch.where((metric_ids == i)[:, None], one(kind), contrib)
    return torch.where(mask, contrib, 0.0), mask


def metric_batch_moments(adj, sources: torch.Tensor, valid: torch.Tensor,
                         metric_ids: torch.Tensor, *, kinds, hops: int = 0,
                         iterate: str = "while", max_iters_bf: int = 0,
                         max_iters_br: int = 0
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``mfbc_batch_moments`` generalized over per-row metrics.

    Returns (S1, S2, n_reach) over the batch's valid sources, where each
    row's contribution formula is ``kinds[metric_ids[row]]``'s.
    """
    contrib, mask = _metric_contrib(adj, sources, valid, metric_ids,
                                    kinds=kinds, hops=hops, iterate=iterate,
                                    max_iters_bf=max_iters_bf,
                                    max_iters_br=max_iters_br)
    return _rows(contrib, mask)


def metric_batch_moments_segmented(adj, sources: torch.Tensor,
                                   valid: torch.Tensor, slot_ids: np.ndarray,
                                   metric_ids: torch.Tensor, *, kinds,
                                   n_slots: int, hops: int = 0,
                                   iterate: str = "while",
                                   max_iters_bf: int = 0,
                                   max_iters_br: int = 0
                                   ) -> Tuple[torch.Tensor, torch.Tensor,
                                              torch.Tensor]:
    """``mfbc_batch_moments_segmented`` generalized over per-row metrics.

    The cross-metric fusion primitive: a closeness epoch and a BC forward
    sweep share one relax sequence, each slot's rows selecting their own
    contribution formula. ``segment_fold`` adds each slot's rows in row
    order, so slot j's statistics are bitwise those of its rows alone
    under the same sweep structure.
    """
    contrib, mask = _metric_contrib(adj, sources, valid, metric_ids,
                                    kinds=kinds, hops=hops, iterate=iterate,
                                    max_iters_bf=max_iters_bf,
                                    max_iters_br=max_iters_br)
    return _fold_moments(contrib, mask, slot_ids, n_slots)


def mfbc(g: Graph, *, n_b: Optional[int] = None, backend: str = "dense",
         iterate: str = "while", max_iters: int = 0, block: int = 512,
         sources: Optional[np.ndarray] = None, progress_cb=None,
         device="cuda") -> np.ndarray:
    """Full betweenness centrality of a host graph.

    Args:
      g: host COO graph (positive weights).
      n_b: batch size (paper's memory/time tradeoff). Default min(n, 64).
      backend: "dense" (the product kernels), "coo" (segment-op message
        passing) or "csr" (frontier-compacted segment-op message passing).
      iterate: "while" | "fori" (fixed ``max_iters`` iterations).
      max_iters: iteration bound for "fori" (default n-1).
      block: u-block of the SP-DAG child count's plain form, which runs
        on the CPU only (the card's kernel has its own tiles).
      sources: optionally restrict to these sources (approximate BC).
      progress_cb: optional callback(batch_idx, n_batches, lam_partial)
        — the checkpoint hook.
      device: "cuda" (default; raises if there is no card) or "cpu".

    Returns:
      λ: (n,) float64 centrality scores (ordered-pair convention, endpoints
      excluded — matches the paper's λ definition).
    """
    dev = resolve_device(device)
    n = g.n
    if n_b is None:
        n_b = min(n, 64)
    if backend == "dense":
        adj = dense_adj_from_graph(g, block=block, device=dev)
    elif backend == "coo":
        adj = coo_adj_from_graph(g, device=dev)
    elif backend == "csr":
        adj = csr_adj_from_graph(g, n_b=n_b, device=dev)
    else:
        raise ValueError(f"unknown backend {backend!r}")
    all_sources = np.arange(n, dtype=np.int32) if sources is None \
        else np.asarray(sources, dtype=np.int32)
    n_batches = -(-all_sources.shape[0] // n_b)
    lam = np.zeros(n, dtype=np.float64)
    for b in range(n_batches):
        chunk = all_sources[b * n_b:(b + 1) * n_b]
        valid = np.ones(chunk.shape[0], dtype=bool)
        if chunk.shape[0] < n_b:  # pad the ragged tail (paper's n mod n_b trick)
            pad = n_b - chunk.shape[0]
            chunk = np.concatenate([chunk, np.zeros(pad, np.int32)])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        lam_b, _, _ = mfbc_batch(adj, torch.from_numpy(chunk).to(dev),
                                 torch.from_numpy(valid).to(dev),
                                 iterate=iterate, max_iters_bf=max_iters,
                                 max_iters_br=max_iters)
        lam += lam_b.cpu().numpy().astype(np.float64)
        if progress_cb is not None:
            progress_cb(b, n_batches, lam)
    return lam
