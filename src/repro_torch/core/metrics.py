"""Metric registry — the sweep structure of every supported graph metric.

The registry half of ``repro/core/metrics.py``, copied: ``MetricSpec`` and
its registrations are the single source of truth for ``BCQuery``
validation, planner pricing, executor dispatch and fusion grouping. The
port runs betweenness only so far; closeness, k-hop and components (the
batch bodies and ``components_graph`` / ``components_labels``) are slice 4
of ROADMAP.md, and the executor raises ``NotImplementedError`` for them.

Per-source contribution semantics (all share MFBF's maximal-frontier
forward sweep and the ``t = s`` self-mask):

* ``betweenness`` — δ_s(v) = ζ(s, v)·σ̄(s, v): forward + backward sweep
  (Algorithm 3), the paper's own workload.
* ``closeness``   — δ_s(v) = τ(s, v) where finite: forward sweep only.
* ``khop``        — δ_s(v) = 1 iff v is within ``hops`` edges of s: a
  bounded forward sweep of ``hops - 1`` iterations (Lemma 4.1).
* ``components``  — weak connectivity as a min-label fixed point; exact
  by construction, so it bypasses the estimator entirely.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """How one metric sweeps through the shared relaxation engine.

    Attributes:
      name: registry key (``BCQuery.metric`` values).
      sweeps: α-β-priced relax sweeps per batch — the planner prices
        ``iters_total = sweeps * est_iters * n_batches``, so forward-only
        metrics cost half of BC's forward+backward pair.
      sampled: the adaptive-sampling estimator path applies (per-source
        contributions are i.i.d. samples of a per-vertex total).
      needs_backward: the batch body runs MFBr after MFBF.
      bounded: the forward sweep is bounded by ``BCQuery.hops``.
      fixed_point: whole-graph label fixed point — exact only, computed
        in one executor call, never sampled and never fused.
      description: one line for docs and metrics surfaces.
    """

    name: str
    sweeps: int
    sampled: bool
    needs_backward: bool = False
    bounded: bool = False
    fixed_point: bool = False
    description: str = ""


_METRIC_REGISTRY: Dict[str, MetricSpec] = {}


def register_metric(spec: MetricSpec) -> MetricSpec:
    """Register (or override) the spec for a metric name."""
    _METRIC_REGISTRY[spec.name] = spec
    return spec


def metric_spec(name: str) -> MetricSpec:
    try:
        return _METRIC_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown metric {name!r} (registered: "
            f"{', '.join(sorted(_METRIC_REGISTRY))})") from None


def registered_metrics() -> Tuple[str, ...]:
    return tuple(sorted(_METRIC_REGISTRY))


def fuse_group(name: str, hops: int = 0) -> str:
    """``step_segmented`` compatibility key: requests whose groups match
    may share one fused device batch (identical forward-sweep structure).

    Unbounded forward sweeps all share ``"sweep"``; hop-bounded sweeps
    group per bound, and fixed-point metrics never fuse.
    """
    spec = metric_spec(name)
    if spec.fixed_point:
        return f"fixed_point:{name}"
    if spec.bounded:
        return f"bounded:{int(hops)}"
    return "sweep"


register_metric(MetricSpec(
    name="betweenness", sweeps=2, sampled=True, needs_backward=True,
    description="shortest-path betweenness λ(v) (Algorithm 3, "
                "forward + backward sweep)"))
register_metric(MetricSpec(
    name="closeness", sweeps=1, sampled=True,
    description="farness Σ_s τ(s, v) — the SSSP distance-profile "
                "aggregate, forward sweep only"))
register_metric(MetricSpec(
    name="khop", sweeps=1, sampled=True, bounded=True,
    description="k-hop in-reachability |{s : τ_hops(s, v) < ∞}| — "
                "bounded forward sweep (Lemma 4.1)"))
register_metric(MetricSpec(
    name="components", sweeps=1, sampled=False, fixed_point=True,
    description="weakly connected components as a min-label fixed point "
                "over the zero-weight symmetrized structure"))

METRICS = registered_metrics()
