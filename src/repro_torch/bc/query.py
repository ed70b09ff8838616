"""BCQuery — what the caller wants, decoupled from how it runs.

A copy of ``repro/bc/query.py`` without its deprecated ``backend=`` /
``use_kernel=`` / ``block=`` keywords: pin the execution with
``execution=ExecutionConfig(...)``. The solver splits a request into three
layers:

* **query** (this module) — accuracy/budget intent: exact or approximate,
  (ε, δ) targets, top-k early exit, stopping rule, seed, sample cap.
* **plan** (``repro_torch.bc.planner``) — the chosen execution
  configuration: backend, batch size n_b (plus its power-of-two serving
  ``buckets``), placement, predicted cost.
* **executor** (``repro_torch.bc.executor``) — the batch step behind one
  ``step(sources, valid) -> (S1, S2, n_reach)`` protocol (plus the
  slot-tagged ``step_segmented`` fused variant).

``n_b`` and ``execution`` are optional pins: ``None`` means "let the
planner decide".
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.bc.config import Backend, ExecutionConfig
from repro_torch.core.metrics import metric_spec

MODES = ("exact", "approx")
RULES = ("bernstein", "normal")
STRATEGIES = ("adaptive", "uniform")
BACKENDS = tuple(b.value for b in Backend)

# Latency tiers, the QoS vocabulary of the serving stack: a plan records
# the tier it was sized for, and the scheduler turns it into a deadline
# (``TIER_DEADLINE_S`` when the request gives no explicit one).
TIERS = ("interactive", "normal", "batch")
TIER_DEADLINE_S = {"interactive": 0.5, "normal": 5.0, "batch": 60.0}


@dataclasses.dataclass(frozen=True)
class BCQuery:
    """One betweenness-centrality request.

    Accuracy semantics for ``mode="approx"`` match ``repro_torch.approx``:
    ``eps`` is the CI halfwidth target on the normalized dependency scale
    ``δ_s(v)/(n-2) ∈ [0, 1]``, ``delta`` the total failure probability,
    ``rule`` the CI family (rigorous empirical-Bernstein vs CLT profile),
    ``topk`` an optional CI-separation early exit, and ``max_samples`` a
    hard cap overriding the Hoeffding budget. ``mode="exact"`` ignores
    the accuracy knobs and sweeps every source.
    """

    mode: str = "exact"
    # -- metric (MetricSpec registry, repro_torch.core.metrics) ----------
    metric: str = "betweenness"
    hops: int = 0  # khop's bound (edges); required >= 1 iff metric="khop"
    # -- approx accuracy / budget ---------------------------------------
    eps: float = 0.05
    delta: float = 0.1
    rule: str = "bernstein"
    strategy: str = "adaptive"
    topk: Optional[int] = None
    max_samples: Optional[int] = None
    seed: int = 0
    tier: Optional[str] = None  # latency tier (serving QoS); None = untiered
    # -- hints ----------------------------------------------------------
    weighted: Optional[bool] = None  # None = infer from the graph
    # -- planner overrides (None / 0 = planner decides) -----------------
    n_b: Optional[int] = None
    execution: Optional[ExecutionConfig] = None  # typed execution pins
    iters: int = 0  # static sweep bound for mesh plans (0 = graph size)

    def __post_init__(self) -> None:
        if self.mode not in MODES:
            raise ValueError(f"mode must be one of {MODES}, got {self.mode!r}")
        if self.rule not in RULES:
            raise ValueError(f"rule must be one of {RULES}, got {self.rule!r}")
        if self.strategy not in STRATEGIES:
            raise ValueError(f"strategy must be one of {STRATEGIES}, "
                             f"got {self.strategy!r}")
        spec = metric_spec(self.metric)  # raises with the registered list
        if spec.bounded:
            if self.hops < 1:
                raise ValueError(f"metric {self.metric!r} needs hops >= 1, "
                                 f"got {self.hops}")
        elif self.hops:
            raise ValueError(f"hops only applies to hop-bounded metrics, "
                             f"not {self.metric!r}")
        if spec.fixed_point and self.mode != "exact":
            raise ValueError(f"metric {self.metric!r} is a fixed point — "
                             f"exact only, not mode={self.mode!r}")
        if self.execution is None:
            object.__setattr__(self, "execution", ExecutionConfig())
        if self.tier is not None and self.tier not in TIERS:
            raise ValueError(f"tier must be None or one of {TIERS}, "
                             f"got {self.tier!r}")
        if self.mode == "approx" and not (0.0 < self.eps < 1.0
                                          and 0.0 < self.delta < 1.0):
            raise ValueError(f"approx mode needs eps, delta in (0, 1), got "
                             f"eps={self.eps} delta={self.delta}")
