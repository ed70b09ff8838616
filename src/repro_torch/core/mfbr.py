"""MFBr — Maximal Frontier Brandes back-propagation (paper Algorithm 2).

Given distances/multiplicities ``T = (Tw, Tm)`` from MFBF, computes the
partial centrality factors ``ζ(s, v) = δ(s, v) / σ̄(s, v)``.

The Lemma 4.2 semantics with the counter mechanism:

* ``c0(s, v)`` = number of SP-DAG children of ``v`` (vertices ``u`` with
  ``τ(s,v) + A(v,u) = τ(s,u)``), counted in one shot.
* A vertex enters the frontier exactly once, when its counter hits zero
  (all children have reported), carrying ``1/σ̄(s,v) + ζ(s,v)``; it is then
  retired (the paper's ``c = -1`` state, here the ``done`` mask).
* Each round back-propagates the frontier with the centpath action
  ``g((w,p,c), a) = (w-a, p, c)`` and the ⊗ max-select: a predecessor ``v``
  accepts a contribution iff the shifted weight equals ``τ(s, v)`` exactly —
  i.e. the arc is on a shortest path — accumulating ``Σ_u (1/σ̄(s,u)+ζ(s,u))``
  and decrementing its counter by the number of children that reported.

The caller must mask the self-destination ``T(s, s̄(s)) = (∞, 1)`` first
(σ(s, t, v) with t = s is excluded from betweenness by definition).

As in ``mfbf``, ``iterate="while"`` reads one count per round from the
device: the population of the next frontier, taken from the ``newly`` mask
(with a ``CsrAdj``, in the same copy, the counts of its next bucket pick).

The back-propagation is an ``mfbr`` span of ``repro_torch.tracing``, and
the child count its first child span, ``child_count``, with the count's
``rows`` and ``n`` and ``dense`` 1 for the dense form (``DenseAdj``), 0
for the COO form.
"""
from __future__ import annotations

import torch

from repro_torch import tracing
from repro_torch.core.adjacency import DenseAdj
from repro_torch.core.mfbf import read_counts
from repro_torch.core.monoids import INF, Centpath


def _seed_frontier(Tw, Tm, Zp, newly):
    Fw = torch.where(newly, Tw, -INF)
    Fp = torch.where(newly, Zp + 1.0 / Tm, 0.0)
    return Centpath(Fw, Fp, newly.to(Tw.dtype))


def _step(adj, Tw, Tm, finite, state, hint):
    """One back-prop round on ``state = (Zp, c, done, F)``; returns the new
    state and the population of the next frontier (vertices newly retired
    this round).
    """
    Zp, c, done, F = state
    # P: contributions shifted back along arcs
    relax = getattr(adj, "relax_cp_stats", None)
    P = adj.relax_cp(F) if relax is None else relax(F, hint)[0]
    contrib = (P.w == Tw) & finite & (P.c > 0)
    Zp = Zp + torch.where(contrib, P.p, 0.0)
    c = c - torch.where(contrib, P.c.to(c.dtype), 0)
    newly = finite & (c == 0) & ~done
    F = _seed_frontier(Tw, Tm, Zp, newly)
    return (Zp, c, done | newly, F), newly.sum()


def mfbr(adj, Tw: torch.Tensor, Tm: torch.Tensor, *, iterate: str = "while",
         max_iters: int = 0):
    """Back-propagate centrality factors. Returns ``Zp`` with
    ``Zp[s, v] = ζ(s, v)`` (0 for unreachable/masked vertices)."""
    if iterate not in ("while", "fori"):
        raise ValueError(f"iterate must be 'while' or 'fori', got {iterate!r}")
    with tracing.span("mfbr", Tw.device):
        bound = max_iters if max_iters > 0 else adj.n - 1
        finite = torch.isfinite(Tw)
        # the paper's (∞, 1) reciprocal guard
        Tm_safe = torch.where(Tm > 0, Tm, 1.0)
        with tracing.span("child_count", Tw.device, rows=Tw.shape[0],
                          n=adj.n, dense=int(isinstance(adj, DenseAdj))):
            c0 = adj.count_sp_children(Tw)
        Zp0 = torch.zeros_like(Tw)
        seed = finite & (c0 == 0)
        state = (Zp0, c0, seed, _seed_frontier(Tw, Tm_safe, Zp0, seed))

        if iterate == "fori":
            for _ in range(bound):
                state, _ = _step(adj, Tw, Tm_safe, finite, state, None)
            return state[0]
        probe = getattr(adj, "frontier_counts_cp", None)
        nact, hint = read_counts(seed.sum(), state[3], probe)
        it = 0
        while nact > 0 and it < bound:
            state, count = _step(adj, Tw, Tm_safe, finite, state, hint)
            nact, hint = read_counts(count, state[3], probe)
            it += 1
        return state[0]
