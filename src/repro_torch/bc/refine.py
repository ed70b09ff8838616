"""Resumable approximate-BC refinement from checkpointed (S1, S2, τ).

A copy of ``repro/bc/refine.py``, plus ``carry_checkpoint``, which takes a
checkpoint of the reference's (same fields: numpy sums, ints, the
sampler's state dict) into the port's, so a run begun by the JAX package
resumes here.

The adaptive estimator's whole state is three per-vertex running sums
plus the position of its source-sampling stream — which makes a finished
loose-ε run a *warm start* for a tighter one: restore the sums and the
stream, keep drawing epochs, and test the tighter stopping rule at the
same epoch boundaries a from-scratch run would. This is what lets a
serving result cache answer a tight-ε query with a looser cached entry
*immediately* while the refinement continues in the background, instead
of throwing the cached samples away.

The resume contract: when the original run's epochs were never truncated by its
sample cap (``ApproxCheckpoint.prefix_exact``), a refinement to a
tighter ε is **bitwise identical** to a from-scratch run at that ε over
the same stream — same ``(seed, rid)``-derived RNG, same ``n_b`` epoch
schedule, same chunking. That holds because

* the stream is chunking-invariant (``AdaptiveSampler.draw`` draws
  bounded integers element-wise), so the resumed draws are exactly the
  sources the scratch run would draw after its own identical prefix;
* a stopping rule at ε' < ε can never fire *before* the ε rule did
  (``hw.max() <= ε'`` implies ``hw.max() <= ε``, and the top-k
  separation test is ε-independent), so the scratch tight run walks
  through the same prefix of non-stopping epoch checks the loose run
  recorded — diverging only at (possibly) the loose run's final
  boundary, which ``resume_approx`` re-tests first at the tight ε;
* the estimator folds chunk sums in arrival order, and both paths chop
  each epoch into the same ``n_b``-sized chunks.

A cap-truncated prefix (``prefix_exact=False``) still refines correctly
— the sums are real samples either way — but the continued stream no
longer matches a scratch run's, so the bitwise claim is off and callers
that need it (the cache's parity tests) should fall back to scratch.
"""
from __future__ import annotations

import copy
import dataclasses
from typing import Optional, Tuple

import numpy as np

from repro_torch.approx.driver import (ApproxResult, LambdaEstimator,
                                       stopping_check)
from repro_torch.approx.sampling import (AdaptiveSampler, epoch_schedule,
                                         hoeffding_budget)
from repro_torch.bc.executor import BatchExecutor
from repro_torch.bc.solve import honest_converged

__all__ = ["ApproxCheckpoint", "carry_checkpoint", "checkpoint_from",
           "resume_approx"]


@dataclasses.dataclass
class ApproxCheckpoint:
    """Everything needed to resume one adaptive run at a tighter target.

    ``s1``/``s2``/``tau`` are the estimator's running (Σδ, Σδ², count)
    sums; ``sampler_state`` the stream snapshot
    (``AdaptiveSampler.state()``); ``eps``/``delta``/``rule`` the
    contract the run stopped at; ``n_b`` its epoch schedule unit
    (τ₀ and the chunk size — a resume must reuse it). ``prefix_exact``
    is True iff no epoch was truncated by the run's sample cap, i.e.
    the drawn stream equals what an uncapped schedule would have drawn
    — the precondition of the bitwise resume contract.
    """

    n: int
    eps: float
    delta: float
    rule: str
    n_b: int
    s1: np.ndarray  # (n,) float64 running Σδ
    s2: np.ndarray  # (n,) float64 running Σδ²
    tau: int
    n_epochs: int
    sampler_state: dict
    prefix_exact: bool

    @property
    def growth(self) -> float:
        return 2.0  # the one schedule every production sampler runs


def carry_checkpoint(ckpt) -> ApproxCheckpoint:
    """A port ``ApproxCheckpoint`` with the fields of ``ckpt``, any object
    that has them (the reference's ``repro.bc.refine.ApproxCheckpoint``):
    the sums copied as float64 arrays, the sampler state deep-copied."""
    state = dict(ckpt.sampler_state)
    state["rng_state"] = copy.deepcopy(state["rng_state"])
    return ApproxCheckpoint(
        n=int(ckpt.n), eps=float(ckpt.eps), delta=float(ckpt.delta),
        rule=str(ckpt.rule), n_b=int(ckpt.n_b),
        s1=np.array(ckpt.s1, np.float64), s2=np.array(ckpt.s2, np.float64),
        tau=int(ckpt.tau), n_epochs=int(ckpt.n_epochs),
        sampler_state=state, prefix_exact=bool(ckpt.prefix_exact))


def _untruncated(drawn: int, ei: int, n_b: int, growth: float = 2.0) -> bool:
    """True iff ``drawn`` equals the raw (cap-free) schedule prefix sum."""
    sched = epoch_schedule(n_b, growth)
    return drawn == sum(next(sched) for _ in range(ei))


def checkpoint_from(est: LambdaEstimator, sampler: AdaptiveSampler,
                    *, n_epochs: int) -> ApproxCheckpoint:
    """Snapshot a run's estimator + stream (arrays copied, not aliased)."""
    state = sampler.state()
    return ApproxCheckpoint(
        n=est.n, eps=est.eps, delta=est.delta, rule=est.rule,
        n_b=sampler.n_b, s1=est.s1.copy(), s2=est.s2.copy(), tau=est.tau,
        n_epochs=int(n_epochs), sampler_state=state,
        prefix_exact=_untruncated(state["drawn"], state["ei"], sampler.n_b))


def resume_approx(executor: BatchExecutor, ckpt: ApproxCheckpoint, *,
                  eps: float, delta: Optional[float] = None,
                  topk: Optional[int] = None,
                  max_samples: Optional[int] = None,
                  metric: str = "betweenness", hops: int = 0
                  ) -> Tuple[ApproxResult, ApproxCheckpoint]:
    """Continue a checkpointed run to a tighter ε; returns (result, ckpt).

    Restores the (S1, S2, τ) sums into a fresh estimator at the new
    target, re-tests the stopping rule at the *last completed* epoch
    boundary (a scratch run at ``eps`` would have tested there too —
    if it passes, the cached sums already certify the tighter target
    and nothing is sampled), then keeps drawing epochs through
    ``executor.step`` in ``n_b``-sized chunks — the classic
    per-request chunking — until the tighter rule fires or the new
    Hoeffding cap (``max_samples`` override) is reached.

    The returned checkpoint snapshots the *refined* run, so a chain of
    progressively tighter refinements stays resumable (the cache keeps
    only the tightest entry per key).
    """
    n = ckpt.n
    d = ckpt.delta if delta is None else delta
    est = LambdaEstimator(n, eps, d, ckpt.rule)
    est.s1 = ckpt.s1.copy()
    est.s2 = ckpt.s2.copy()
    est.tau = int(ckpt.tau)
    cap = (hoeffding_budget(n, eps, d) if max_samples is None
           else max_samples)
    sampler = AdaptiveSampler.from_state(n, ckpt.sampler_state, eps=eps,
                                         delta=d, n_b=ckpt.n_b, cap=cap)
    n_epochs = ckpt.n_epochs
    converged = False
    if n_epochs > 0:
        done, _ = stopping_check(est, eps, topk, n_epochs - 1)
        if done:
            converged = True
            sampler.stop()
    while not converged:
        nxt = sampler.next_epoch()
        if nxt is None:
            break
        ei, tau_e = nxt
        sources = sampler.draw(tau_e)
        for lo in range(0, tau_e, ckpt.n_b):
            chunk = sources[lo:lo + ckpt.n_b]
            # metric/hops must match the checkpointed run's — the sums
            # being resumed are per-metric contributions (the cache keys
            # entries per metric, so a refine never crosses metrics).
            s1, s2, _ = executor.step(chunk, np.ones(chunk.shape[0], bool),
                                      metric=metric, hops=hops)
            est.update(s1, s2, int(chunk.shape[0]))
        n_epochs = ei + 1
        done, _ = stopping_check(est, eps, topk, ei)
        if done:
            converged = True
            sampler.stop()
    if not converged and sampler.capped:
        converged = honest_converged(est)
    res = est.result(n_epochs=n_epochs, converged=converged)
    return res, checkpoint_from(est, sampler, n_epochs=n_epochs)
