"""Metric registry — the sweep structure of every supported graph metric.

A port of ``repro/core/metrics.py``. ``MetricSpec`` and its registrations
are the single source of truth for ``BCQuery`` validation, planner
pricing, executor dispatch and fusion grouping. Every metric is a monoid
sweep over the same relax (``adj.relax_mp`` on the dense, COO and CSR
backends alike): the sampled metrics' batch bodies are in
``repro_torch.core.mfbc`` (``metric_batch_moments*``), and the components
fixed point is here (``components_graph``, ``components_labels``).

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

import numpy as np
import torch

from repro_torch.core.adjacency import DenseAdj
from repro_torch.core.mfbf import read_counts
from repro_torch.core.monoids import INF, Multpath, multpath_combine
from repro_torch.graphs.formats import Graph


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


# ------------------------------------------------------------ components
def components_graph(g: Graph) -> Graph:
    """The zero-weight symmetrized pseudo-graph the label sweep runs on.

    Weak connectivity ignores direction and weight: symmetrize the arc
    structure (``Graph.symmetrize`` dedups and drops loops), then zero the
    weights so relaxation propagates labels unchanged (label + 0 = label).
    Every backend's adjacency builder accepts the result: ``coo_to_dense``
    keeps a zero-weight arc apart from the ``inf`` off-structure, and
    padding arcs stay ``inf``-weighted self loops.
    """
    sym = g.symmetrize()
    return Graph(sym.n, sym.src, sym.dst,
                 np.zeros(sym.nnz, dtype=np.float32),
                 directed=False, name=f"{g.name}+cc")


def components_labels(adj) -> torch.Tensor:
    """Min-label fixed point: (n,) float32 labels, one per weak component.

    One (1, n) Multpath row holds the current labels (initially each
    vertex's own id). Each relax computes, per vertex, the minimum label
    over in-neighbours on the zero-weight structure; the frontier keeps
    only improved entries, and the loop stops when nothing improves (or
    after n relaxes, as the reference caps it). Labels are integer-valued
    float32 (exact to 2²⁴), so the fixed point is bitwise the min vertex id
    of each component, what a host union-find gives
    (``brandes_ref.cc_ref``).

    One device-to-host read per iteration: the count of improved labels,
    and on a ``CsrAdj`` in the same copy the counts its next relax picks a
    bucket from (``mfbf.read_counts``).
    """
    n = adj.n
    dev = (adj.a if isinstance(adj, DenseAdj) else adj.w).device
    ids = torch.arange(n, dtype=torch.float32, device=dev)[None, :]
    T = F = Multpath(ids, torch.ones_like(ids))
    relax = getattr(adj, "relax_mp_stats", None)
    probe = getattr(adj, "frontier_counts_mp", None)
    nact, hint = 1, None if probe is None else tuple(probe(F).tolist())
    it = 0
    while nact > 0 and it < n:
        C = adj.relax_mp(F) if relax is None else relax(F, hint)[0]
        T_new = multpath_combine(T, C)
        improved = T_new.w < T.w
        F = Multpath(torch.where(improved, T_new.w, INF),
                     torch.where(improved, 1.0, 0.0))
        T = T_new
        nact, hint = read_counts(improved.sum(), F, probe)
        it += 1
    return T.w[0]
