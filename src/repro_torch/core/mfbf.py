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
relax then reads its counts itself). A ``CsrAdj`` counts the relaxes its
buckets served and those that fell back to the full edge list
(``compact_hits``, ``overflows``).

The sweep is an ``mfbf`` span of ``repro_torch.tracing``.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import tracing
from repro_torch.core.monoids import INF, Multpath, multpath_combine

def read_counts(count: torch.Tensor, F, probe) -> Tuple[int, Optional[tuple]]:
    """The sweep's one device-to-host read per iteration: the frontier's
    population and, where the adjacency compacts (``probe`` is its
    ``frontier_counts_*``), the counts its next relax picks a bucket from.
    Each call counts one ``host_syncs`` (``repro_torch.tracing``).
    """
    tracing.count("host_syncs")
    if probe is None:
        return int(count.item()), None
    vals = torch.cat([count.reshape(1).to(torch.int64), probe(F)]).tolist()
    return vals[0], tuple(vals[1:])


def _frontier_active(F: Multpath) -> torch.Tensor:
    return torch.isfinite(F.w) & (F.m > 0)


def _step(adj, T: Multpath, F: Multpath, hint):
    """One maximal-frontier relaxation: returns (T', F', |F' active|).
    ``hint``: the frontier's counts, read already."""
    # C: the exactly-(j+1)-edge minimal paths from the frontier
    relax = getattr(adj, "relax_mp_stats", None)
    C = adj.relax_mp(F) if relax is None else relax(F, hint)[0]
    T_new = multpath_combine(T, C)
    # New frontier: candidates that match the (possibly improved) best
    # distance. Exactly-j-edge path classes are disjoint, so multiplicities
    # accumulate without double counting.
    keep = (C.w == T_new.w) & torch.isfinite(C.w) & (C.m > 0)
    F_new = Multpath(torch.where(keep, C.w, INF), torch.where(keep, C.m, 0.0))
    return T_new, F_new, keep.sum()


def mfbf(adj, sources: torch.Tensor, *, iterate: str = "while",
         max_iters: int = 0):
    """Run MFBF for one batch of sources.

    Args:
      adj: DenseAdj, CooAdj or CsrAdj.
      sources: (nb,) integer vertex ids on the adjacency's device.
      iterate: "while" for a loop that stops when the frontier empties,
        "fori" for a fixed ``max_iters`` iterations (must upper-bound the
        SP edge count).
      max_iters: iteration bound; also caps the while loop defensively
        (0 means n - 1).

    Returns:
      (Tw, Tm): (nb, n) distances and multiplicities. Unreachable = (inf, 0).
    """
    if iterate not in ("while", "fori"):
        raise ValueError(f"iterate must be 'while' or 'fori', got {iterate!r}")
    with tracing.span("mfbf", sources.device):
        bound = max_iters if max_iters > 0 else adj.n - 1
        Tw0 = adj.gather_rows(sources)  # direct edges (nb, n); paper line 1
        T = Multpath(Tw0, torch.isfinite(Tw0).to(Tw0.dtype))
        F = T  # paper line 2: initial frontier = exactly-1-edge paths

        if iterate == "fori":
            for _ in range(bound):
                T, F, _ = _step(adj, T, F, None)
            return T.w, T.m
        probe = getattr(adj, "frontier_counts_mp", None)
        nact, hint = read_counts(_frontier_active(F).sum(), F, probe)
        it = 0
        while nact > 0 and it < bound:
            T, F, count = _step(adj, T, F, hint)
            nact, hint = read_counts(count, F, probe)
            it += 1
        return T.w, T.m
