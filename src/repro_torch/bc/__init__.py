"""repro_torch.bc — the betweenness-centrality solver facade of the port.

One query → plan → executor surface, ported from ``repro.bc`` for the
dense, COO and CSR backends on one device and for the distributed dense
step on a mesh:

* ``BCQuery`` — what the caller wants (exact/approx, ε/δ/top-k/rule, seed,
  sample cap, optional n_b and ``ExecutionConfig`` pins).
* ``BCPlanner`` / ``BCPlan`` — the configuration search as an inspectable,
  JSON-serializable object, equal to the reference's for the same query.
* ``SingleHostExecutor`` — ``step`` / ``step_sum`` / ``step_segmented``
  on the card's Hopper kernels (or their plain versions on the CPU), and
  the CSR backend's ``occupancy_summary``.
* ``MeshExecutor`` — the Theorem 5.1 moments step of betweenness on a
  (pod, data, model) mesh of ``torch.distributed`` ranks
  (``repro_torch.launch.mesh``).
* ``solve`` — the exact sweep and the adaptive/uniform sampling epochs.

Typical use::

    from repro_torch.bc import BCQuery, ExecutionConfig, solve

    q = BCQuery(mode="approx", eps=0.05, delta=0.1, topk=10, n_b=64,
                execution=ExecutionConfig(backend="dense"))
    res = solve(g, q)                       # on the card
    res.topk(10), res.approx.halfwidth

The serving stack's fusion surface lives here too: ``plan_for_request``,
``BatchAssembler`` / ``FusedBatch`` / ``scatter`` and ``honest_converged``,
and the refinement surface: ``ApproxCheckpoint``, ``checkpoint_from``,
``resume_approx`` and ``carry_checkpoint``. Every registered metric runs
(``BCQuery(metric=...)``: betweenness, closeness, khop, components).
"""
from repro_torch.approx.driver import (ApproxResult, LambdaEstimator,
                                       choose_sample_batch, stopping_check)
from repro_torch.approx.sampling import AdaptiveSampler, UniformSampler
from repro_torch.bc.config import Backend, ExecutionConfig, as_backend
from repro_torch.bc.executor import (BackendSpec, BatchExecutor,
                                     MeshExecutor, SingleHostExecutor,
                                     backend_spec,
                                     build_executor, register_backend,
                                     registered_backends)
from repro_torch.bc.fusion import (PACKS, BatchAssembler, FusedBatch,
                                   order_demand, scatter)
from repro_torch.bc.planner import (BCPlan, BCPlanner, bucket_sizes,
                                    plan_for_request)
from repro_torch.bc.query import TIER_DEADLINE_S, TIERS, BCQuery
from repro_torch.bc.refine import (ApproxCheckpoint, carry_checkpoint,
                                   checkpoint_from, resume_approx)
from repro_torch.bc.solve import BCResult, honest_converged, plan, solve
from repro_torch.core.metrics import (METRICS, MetricSpec, fuse_group,
                                      metric_spec, register_metric,
                                      registered_metrics)

__all__ = [
    "BCQuery", "BCPlan", "BCPlanner", "BCResult",
    "Backend", "ExecutionConfig", "as_backend",
    "BackendSpec", "register_backend", "backend_spec", "registered_backends",
    "MetricSpec", "register_metric", "metric_spec", "registered_metrics",
    "METRICS", "fuse_group",
    "BatchExecutor", "SingleHostExecutor", "MeshExecutor", "build_executor",
    "plan", "solve", "honest_converged",
    "BatchAssembler", "FusedBatch", "scatter", "order_demand", "PACKS",
    "TIERS", "TIER_DEADLINE_S",
    "plan_for_request", "bucket_sizes",
    "ApproxCheckpoint", "checkpoint_from", "resume_approx",
    "carry_checkpoint",
    "ApproxResult", "LambdaEstimator", "stopping_check",
    "choose_sample_batch", "AdaptiveSampler", "UniformSampler",
]
