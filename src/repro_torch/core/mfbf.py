"""MFBF — Maximal Frontier Bellman-Ford (paper Algorithm 1, Lemma 4.1).

Computes, for a batch of ``n_b`` sources, the shortest distance ``τ(s, v)``
and the shortest-path multiplicity ``σ̄(s, v)`` for every vertex ``v``.

Loop invariant (the Lemma 4.1 induction): after ``j`` iterations

* ``T``  holds weight/multiplicity of all shortest paths of **≤ j+1** edges,
* the frontier ``F`` holds weight/multiplicity of minimal-weight paths of
  **exactly j+1** edges that tie the current best (everything that can still
  make progress — the *maximal* frontier).

Inactive frontier entries are ``(∞, 0)``, so they are never relaxed; ``T``'s
multiplicity for unreachable vertices is clamped to 1 just before
reciprocals are taken in MFBr (the paper's ``(∞, 1)`` trick).

``iterate="while"`` stops when the frontier empties: ``_step`` counts the
next frontier from the ``keep`` mask it already builds, and reading that
count is the loop's one device-to-host read per iteration; the loop never
re-reduces the ``(n_b, n)`` frontier. A frontier-compacting adjacency
(``CsrAdj``) picks its next bucket from two more counts of the new
frontier, read in the same copy (``read_counts``). ``iterate="fori"`` runs a
fixed ``max_iters`` iterations with no host read of its own (a ``CsrAdj``
relax then reads its counts itself).

``trace=True`` also returns a :class:`SweepTrace`, kept on the host as
Python ints: per-iteration frontier nnz plus, for a compacting adjacency,
how many relax calls a capacity bucket served and how many overflowed to
the full edge list. It always runs the while loop, as the reference does.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.monoids import INF, Multpath, multpath_combine

# Fixed-size per-iteration occupancy trace; iterations past the cap fold
# into the last slot (so ``fnnz[min(iters, cap) - 1]`` is always the tail).
TRACE_CAP = 64


class SweepTrace(NamedTuple):
    """Occupancy side channel of one frontier sweep (MFBF or MFBr)."""

    fnnz: Tuple[int, ...]  # (TRACE_CAP,) frontier nnz per iteration; -1 unused
    iters: int  # iterations executed
    overflows: int  # relax calls on the full-edge-list fallback
    compact_hits: int  # relax calls served by a capacity bucket


def empty_trace() -> SweepTrace:
    return SweepTrace((-1,) * TRACE_CAP, 0, 0, 0)


def record(tr: SweepTrace, it: int, nact: int, stats) -> SweepTrace:
    """``tr`` after iteration ``it``, whose frontier held ``nact`` entries
    and whose relax reported ``stats`` (a ``RelaxStats``, or None for a
    format without compaction)."""
    fnnz = list(tr.fnnz)
    fnnz[min(it, TRACE_CAP - 1)] = nact
    over = 0 if stats is None else stats.overflow
    hit = 0 if stats is None else 1 - stats.overflow
    return SweepTrace(tuple(fnnz), it + 1, tr.overflows + over,
                      tr.compact_hits + hit)


def read_counts(count: torch.Tensor, F, probe) -> Tuple[int, Optional[tuple]]:
    """The sweep's one device-to-host read per iteration: the frontier's
    population and, where the adjacency compacts (``probe`` is its
    ``frontier_counts_*``), the counts its next relax picks a bucket from.
    """
    if probe is None:
        return int(count.item()), None
    vals = torch.cat([count.reshape(1).to(torch.int64), probe(F)]).tolist()
    return vals[0], tuple(vals[1:])


def _frontier_active(F: Multpath) -> torch.Tensor:
    return torch.isfinite(F.w) & (F.m > 0)


def _step(adj, T: Multpath, F: Multpath, hint):
    """One maximal-frontier relaxation: returns (T', F', |F' active|,
    RelaxStats or None). ``hint``: the frontier's counts, read already."""
    # C: the exactly-(j+1)-edge minimal paths from the frontier
    relax = getattr(adj, "relax_mp_stats", None)
    C, stats = (adj.relax_mp(F), None) if relax is None else relax(F, hint)
    T_new = multpath_combine(T, C)
    # New frontier: candidates that match the (possibly improved) best
    # distance. Exactly-j-edge path classes are disjoint, so multiplicities
    # accumulate without double counting.
    keep = (C.w == T_new.w) & torch.isfinite(C.w) & (C.m > 0)
    F_new = Multpath(torch.where(keep, C.w, INF), torch.where(keep, C.m, 0.0))
    return T_new, F_new, keep.sum(), stats


def mfbf(adj, sources: torch.Tensor, *, iterate: str = "while",
         max_iters: int = 0, trace: bool = False):
    """Run MFBF for one batch of sources.

    Args:
      adj: DenseAdj, CooAdj or CsrAdj.
      sources: (nb,) integer vertex ids on the adjacency's device.
      iterate: "while" for a loop that stops when the frontier empties,
        "fori" for a fixed ``max_iters`` iterations (must upper-bound the
        SP edge count).
      max_iters: iteration bound; also caps the while loop defensively
        (0 means n - 1).
      trace: also return the :class:`SweepTrace`.

    Returns:
      (Tw, Tm): (nb, n) distances and multiplicities. Unreachable = (inf, 0).
      With ``trace=True``: (Tw, Tm, SweepTrace).
    """
    if iterate not in ("while", "fori"):
        raise ValueError(f"iterate must be 'while' or 'fori', got {iterate!r}")
    bound = max_iters if max_iters > 0 else adj.n - 1
    Tw0 = adj.gather_rows(sources)  # direct edges, (nb, n); paper line 1
    T = Multpath(Tw0, torch.isfinite(Tw0).to(Tw0.dtype))
    F = T  # paper line 2: initial frontier = exactly-1-edge paths

    if iterate == "fori" and not trace:
        for _ in range(bound):
            T, F, _, _ = _step(adj, T, F, None)
        return T.w, T.m
    probe = getattr(adj, "frontier_counts_mp", None)
    tr = empty_trace()
    nact, hint = read_counts(_frontier_active(F).sum(), F, probe)
    it = 0
    while nact > 0 and it < bound:
        T, F, count, stats = _step(adj, T, F, hint)
        if trace:
            tr = record(tr, it, nact, stats)
        nact, hint = read_counts(count, F, probe)
        it += 1
    return (T.w, T.m, tr) if trace else (T.w, T.m)
