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
next frontier from the ``keep`` mask it already builds, and that count's
``.item()`` is the loop's one device-to-host read per iteration; the loop
never re-reduces the ``(n_b, n)`` frontier. ``iterate="fori"`` runs a fixed
``max_iters`` iterations with no host read at all.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.monoids import INF, Multpath, multpath_combine


def _frontier_active(F: Multpath) -> torch.Tensor:
    return torch.isfinite(F.w) & (F.m > 0)


def _step(adj, T: Multpath, F: Multpath
          ) -> Tuple[Multpath, Multpath, torch.Tensor]:
    """One maximal-frontier relaxation: returns (T', F', |F' active|)."""
    C = adj.relax_mp(F)  # exactly-(j+1)-edge minimal paths from the frontier
    T_new = multpath_combine(T, C)
    # New frontier: candidates that match the (possibly improved) best
    # distance. Exactly-j-edge path classes are disjoint, so multiplicities
    # accumulate without double counting.
    keep = (C.w == T_new.w) & torch.isfinite(C.w) & (C.m > 0)
    F_new = Multpath(torch.where(keep, C.w, INF), torch.where(keep, C.m, 0.0))
    return T_new, F_new, keep.sum()


def mfbf(adj, sources: torch.Tensor, *, iterate: str = "while",
         max_iters: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Run MFBF for one batch of sources.

    Args:
      adj: DenseAdj.
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
    bound = max_iters if max_iters > 0 else adj.n - 1
    Tw0 = adj.gather_rows(sources)  # direct edges, (nb, n); paper line 1
    T = Multpath(Tw0, torch.isfinite(Tw0).to(Tw0.dtype))
    F = T  # paper line 2: initial frontier = exactly-1-edge paths

    if iterate == "while":
        nact = int(_frontier_active(F).sum().item())
        it = 0
        while nact > 0 and it < bound:
            T, F, count = _step(adj, T, F)
            nact = int(count.item())
            it += 1
    else:
        for _ in range(bound):
            T, F, _ = _step(adj, T, F)
    return T.w, T.m
