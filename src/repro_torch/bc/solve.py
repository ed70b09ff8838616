"""repro_torch.bc.solve — the single entry point over the BC paths.

A port of ``repro/bc/solve.py``. ``solve(g, query)`` plans (unless handed
a ``BCPlan``), builds the executor on ``device``, and runs one of two
drivers over the shared ``step(sources, valid) -> (S1, S2, n_reach)``
protocol:

* **exact** — sweep all sources (or an explicit ``sources`` subset) in
  ``⌈budget/n_b⌉`` padded batches; λ is the running Σ S1. A fixed-point
  metric (components) answers from ``executor.labels()`` instead, with no
  source sweep.
* **approx** — adaptive or uniform sampling epochs: fold batch moments
  into a ``LambdaEstimator``, test the Bernstein/CLT stopping rule at
  epoch boundaries with a geometrically split failure budget, stop early
  on top-k CI separation.

On a mesh, every rank runs the same driver: the sampler is seeded alike
and each batch's statistics are the same on every rank, so every rank
takes the same stopping decisions.

The identity contract: a dense or COO plan passes through ``solve`` by
identity (``solve(..., plan=pl).plan is pl``); a CSR plan comes back as a
copy that carries the executor's frontier-occupancy trace
(``BCPlan.occupancy``, ``_with_occupancy``), as in the reference.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from repro_torch.approx import sampling as S
from repro_torch.approx.driver import (ApproxResult, LambdaEstimator,
                                       stopping_check)
from repro_torch.bc.executor import BatchExecutor, build_executor
from repro_torch.bc.planner import BCPlan, BCPlanner
from repro_torch.bc.query import BCQuery
from repro_torch.core.metrics import metric_spec
from repro_torch.graphs.formats import Graph

_DEFAULT_PLANNER = BCPlanner()


def honest_converged(est: LambdaEstimator) -> bool:
    """Can this estimator's run be certified as converged at its (ε, δ)?

    A sample cap *below* the Hoeffding budget carries no a-priori
    guarantee — only the empirical CIs can still certify convergence
    there; at or past the budget the a-priori bound holds regardless of
    what the CIs say.
    """
    if est.tau >= S.hoeffding_budget(est.n, est.eps, est.delta):
        return True
    return est.converged()


@dataclasses.dataclass
class BCResult:
    """Solver outcome: λ plus the plan that produced it.

    ``approx`` carries the estimator metadata (CIs, sample counts,
    convergence) for approximate queries and is ``None`` for exact ones.
    """

    lam: np.ndarray  # (n,) λ, unnormalized ordered-pair convention
    plan: BCPlan
    query: BCQuery
    seconds: float
    n_swept: int = 0  # sources actually run through the executor
    approx: Optional[ApproxResult] = None

    def topk(self, k: int) -> np.ndarray:
        """Vertex ids of the k largest λ values, descending."""
        return np.argsort(self.lam)[::-1][:k]

    @property
    def converged(self) -> bool:
        return True if self.approx is None else self.approx.converged

    @property
    def n_samples(self) -> int:
        """Sources actually swept (a restricted exact sweep counts only
        its ``sources`` subset)."""
        return self.n_swept if self.approx is None else self.approx.n_samples


def plan(g: Graph, query: Optional[BCQuery] = None, *, mesh=None,
         n_devices: Optional[int] = None,
         planner: Optional[BCPlanner] = None, device="cuda") -> BCPlan:
    """Plan a query without running it (inspectable configuration search)
    for ``device``'s topology."""
    query = query if query is not None else BCQuery()
    planner = planner or _DEFAULT_PLANNER
    return planner.plan(g, query, mesh=mesh, n_devices=n_devices,
                        device=device)


def solve(g: Graph, query: Optional[BCQuery] = None, *, mesh=None,
          plan: Optional[BCPlan] = None,
          executor: Optional[BatchExecutor] = None,
          sources: Optional[np.ndarray] = None,
          planner: Optional[BCPlanner] = None,
          progress_cb: Optional[Callable] = None,
          device="cuda") -> BCResult:
    """Solve one BC query end to end (plan → executor → driver).

    Args:
      g: host COO graph.
      query: what to compute (default: exact sweep).
      mesh: an explicit ``launch.mesh.Mesh``: the distributed step. Every
        rank of the mesh calls ``solve`` with the same arguments and gets
        the same result (a mesh plan with no mesh builds one from
        ``plan.mesh_axes`` over the initialized process group).
      plan: pre-computed ``BCPlan`` (skips planning; ``plan``).
      executor: pre-built executor (reused across requests).
      sources: exact mode only — restrict the sweep to these sources.
      progress_cb: exact mode ``cb(batch, n_batches, λ_running)``;
        approx mode ``cb(epoch, τ, max_halfwidth)``.
      device: "cuda" (default; raises without a card) or "cpu", where
        the executor is built; a pre-built executor keeps its own.

    Returns:
      ``BCResult`` with λ, the executed plan and (approx) CI metadata.
    """
    query = query if query is not None else BCQuery()
    if plan is None:
        plan = (executor.plan if executor is not None
                else (planner or _DEFAULT_PLANNER).plan(
                    g, query, mesh=mesh, device=device))
    if executor is None:
        executor = build_executor(g, plan, mesh=mesh, device=device)
    t0 = time.time()
    if metric_spec(query.metric).fixed_point:
        # components: one whole-graph label fixed point, no source sweep
        return BCResult(lam=executor.labels(), plan=plan, query=query,
                        seconds=time.time() - t0, n_swept=g.n)
    if query.mode == "exact":
        lam, n_swept = _run_exact(g, query, executor, sources, progress_cb)
        return BCResult(lam=lam, plan=_with_occupancy(plan, executor),
                        query=query, seconds=time.time() - t0,
                        n_swept=n_swept)
    res = _run_approx(g, query, executor, progress_cb)
    return BCResult(lam=res.lam, plan=_with_occupancy(plan, executor),
                    query=query, seconds=time.time() - t0,
                    n_swept=res.n_samples, approx=res)


def _with_occupancy(plan: BCPlan, executor: BatchExecutor) -> BCPlan:
    """Attach the executor's frontier-occupancy trace to the executed plan.

    Only the frontier-compacting CSR executor collects one; without it
    the plan passes through *by identity*, so callers that cache the plan
    object keep their reference.
    """
    occ_fn = getattr(executor, "occupancy_summary", None)
    occ = occ_fn() if occ_fn is not None else None
    if occ is None:
        return plan
    return dataclasses.replace(plan, occupancy=occ)


# ---------------------------------------------------------------- drivers
def _run_exact(g: Graph, q: BCQuery, ex: BatchExecutor, sources,
               progress_cb):
    all_sources = (np.arange(g.n, dtype=np.int32) if sources is None
                   else np.asarray(sources, np.int32))
    nb = ex.n_b
    n_batches = -(-all_sources.shape[0] // nb) if all_sources.size else 0
    lam = np.zeros(g.n, dtype=np.float64)
    for b in range(n_batches):
        chunk = all_sources[b * nb:(b + 1) * nb]
        # Σδ-only reduction: the sweep never needs Σδ².
        lam += ex.step_sum(chunk, np.ones(chunk.shape[0], bool),
                           metric=q.metric, hops=q.hops)
        if progress_cb is not None:
            progress_cb(b, n_batches, lam)
    return lam, int(all_sources.shape[0])


def _run_approx(g: Graph, q: BCQuery, ex: BatchExecutor,
                progress_cb) -> ApproxResult:
    n = g.n
    est = LambdaEstimator(n, q.eps, q.delta, q.rule)

    def run_batch(b: S.SampleBatch) -> None:
        s1, s2, _ = ex.step(b.sources, b.valid, metric=q.metric, hops=q.hops)
        est.update(s1, s2, b.n_valid)

    if q.strategy == "uniform":
        sampler = S.UniformSampler(n, eps=q.eps, delta=q.delta, n_b=ex.n_b,
                                   budget=q.max_samples, seed=q.seed)
        epochs = 0
        for b in sampler.batches():
            run_batch(b)
            epochs = b.epoch + 1
        return est.result(n_epochs=epochs, converged=honest_converged(est))

    sampler = S.AdaptiveSampler(n, eps=q.eps, delta=q.delta, n_b=ex.n_b,
                                cap=q.max_samples, seed=q.seed)
    n_epochs = 0
    converged = False
    for ei, batches in sampler.epochs():
        for b in batches:
            run_batch(b)
        n_epochs = ei + 1
        stop, hw = stopping_check(est, q.eps, q.topk, ei)
        if progress_cb is not None:
            progress_cb(ei, est.tau, float(hw.max()))
        if stop:
            converged = True
            sampler.stop()
    if sampler.capped and not converged:
        converged = honest_converged(est)
    return est.result(n_epochs=n_epochs, converged=converged)
