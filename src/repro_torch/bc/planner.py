"""BCPlanner — the configuration search as a first-class object.

A copy of ``repro/bc/planner.py``. Given a graph, a ``BCQuery`` and the
device topology, ``BCPlanner`` consults the α-β cost layer
(``spgemm.autotune.choose_bc_regime`` for the dense/COO/CSR relax regime,
``spgemm.cost_model.best_replication`` for the replication factor c,
``approx.driver.choose_sample_batch`` for n_b) and returns an inspectable,
JSON-serializable ``BCPlan`` whose ``to_json`` equals the reference's for
the same query, topology and calibration.

Topology: where the reference counts jax devices, the port counts
``torch.cuda.device_count()`` when the plan is for the card and 1 when it
is for the CPU. An explicit ``mesh`` (a ``launch.mesh.Mesh``, even 1×1)
pins placement and axes to it; otherwise one device plans single-host and
several plan a (pod, data, model) decomposition, as the reference does:
c = min(best_replication, p^(1/3)) clamped to a divisor of p and the
remaining p/c grid split near-square. Predicted seconds
come from the reference's analytic constants unless the port's own
calibration file exists (``spgemm.cost_model``); they are not H100 times.
"""
from __future__ import annotations

import dataclasses
import math
import warnings
from typing import Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.approx.driver import (adjacency_bytes, choose_sample_batch,
                                       state_bytes)
from repro_torch.approx.sampling import hoeffding_budget
from repro_torch.bc.config import Backend, ExecutionConfig
from repro_torch.core.metrics import metric_spec
from repro_torch.graphs.formats import Graph
from repro_torch.spgemm.autotune import choose_bc_regime
from repro_torch.spgemm.cost_model import (DEFAULT, Calibration, CostParams,
                                           best_replication, load_calibration)

_WORD = 4.0  # f32 device word
BUCKET_FLOOR = 8  # smallest padded batch shape an executor serves


def device_count(device) -> int:
    """Devices a plan for ``device`` may spread over: the visible cards
    for a CUDA device, 1 for the CPU."""
    if torch.device(device).type == "cuda":
        return torch.cuda.device_count()
    return 1


def bucket_sizes(n_b: int, floor: int = BUCKET_FLOOR) -> Tuple[int, ...]:
    """Power-of-two padded batch buckets up to (and including) ``n_b``.

    The shape-bucketing contract shared by the planner (which records the
    set in the ``BCPlan``) and the executor: a fused batch of k sources
    runs at the smallest bucket ≥ k, so ragged demand never pays an
    always-pad-to-``n_b`` waste. On the card every bucket launches the
    kernels with the split count of ``n_b`` (``DenseAdj.for_batches``).
    """
    if n_b <= 0:
        raise ValueError(f"n_b must be positive, got {n_b}")
    out = []
    b = floor
    while b < n_b:
        out.append(b)
        b <<= 1
    out.append(int(n_b))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class BCPlan:
    """One fully resolved execution configuration (what the planner chose).

    Predictions come from the α-β cost layer and are *per device*:
    ``predicted_step_seconds`` prices one relax iteration of one batch,
    ``predicted_comm_bytes`` the whole run's collective traffic
    (Theorem 5.1 bound ``(nnz(F) + 2·nnz(C))/√(p/c)`` per iteration, 0 on
    a single host), ``predicted_seconds`` the end-to-end estimate over
    ``n_batches`` batches of ``est_iters`` forward+backward iterations,
    and ``predicted_mem_bytes`` the peak adjacency+state footprint.
    """

    mode: str  # "exact" | "approx"
    placement: str  # "single_host" | "mesh"
    backend: str  # "dense" | "coo" | "csr" (flat mirror of execution.backend)
    use_kernel: bool
    n_b: int
    block: int
    iters: int  # static mesh sweep bound (0 = graph size)
    n_devices: int
    mesh_axes: Optional[Tuple[Tuple[str, int], ...]]  # None on single host
    sample_budget: int  # n for exact; Hoeffding budget / cap for approx
    n_batches: int
    est_iters: int  # relax iterations priced per batch (heuristic)
    predicted_step_seconds: float
    predicted_comm_bytes: float
    predicted_seconds: float
    predicted_mem_bytes: float
    regime: Dict[str, float]  # choose_bc_regime output (dense/coo/csr)
    buckets: Tuple[int, ...] = ()  # padded batch shapes the executor serves
    tier: Optional[str] = None  # latency tier of the request this plan sizes
    # Metric this plan prices (MetricSpec registry): forward-only sweeps
    # cost half of BC's forward+backward pair via ``spec.sweeps``.
    metric: str = "betweenness"
    hops: int = 0  # khop's bound; 0 for unbounded metrics
    # fully resolved typed execution choice (backend/use_kernel/placement
    # above are its flat mirrors, kept for JSON and legacy readers)
    execution: Optional[ExecutionConfig] = None
    notes: Tuple[str, ...] = ()  # planner diagnostics (e.g. forced fallbacks)
    # Frontier-occupancy trace of an *executed* plan (attached by
    # ``solve`` after the run when the executor collected one — the
    # frontier-sparse CSR backend's side channel): per-iteration frontier
    # nnz of the last batch's forward/backward sweeps, compaction hit
    # rate and overflow count. None on freshly planned (or dense/COO) plans.
    occupancy: Optional[Dict] = None

    def axes_dict(self) -> Optional[Dict[str, int]]:
        return dict(self.mesh_axes) if self.mesh_axes is not None else None

    def to_json(self) -> Dict:
        """JSON-serializable view (benchmarks record this next to timings)."""
        d = dataclasses.asdict(self)
        d["mesh_axes"] = self.axes_dict()
        d["buckets"] = list(self.buckets)
        d["backend"] = str(getattr(self.backend, "value", self.backend))
        d["execution"] = (self.execution.to_json()
                          if self.execution is not None else None)
        d["notes"] = list(self.notes)
        # Wire-schema compat: the occupancy side channel only appears on
        # executed CSR plans — older clients (and the golden fixture)
        # never see the key.
        if d.get("occupancy") is None:
            d.pop("occupancy", None)
        # Same rule for the metric fields: default-metric plans keep the
        # pre-metric wire schema byte-stable.
        if d.get("metric") == "betweenness":
            d.pop("metric", None)
        if not d.get("hops"):
            d.pop("hops", None)
        return d

    @classmethod
    def from_json(cls, d: Dict) -> "BCPlan":
        """Inverse of ``to_json`` — the serving wire form round-trips.

        Restores the tuple/enum shapes JSON flattens (``mesh_axes`` dict
        → ordered pairs, ``buckets``/``notes`` lists → tuples, the
        nested ``execution`` dict → ``ExecutionConfig``), so
        ``BCPlan.from_json(p.to_json())== p`` for any planner output.
        """
        d = dict(d)
        axes = d.get("mesh_axes")
        d["mesh_axes"] = (None if axes is None
                          else tuple((k, int(v)) for k, v in axes.items()))
        d["buckets"] = tuple(int(b) for b in d.get("buckets") or ())
        d["notes"] = tuple(d.get("notes") or ())
        ex = d.get("execution")
        d["execution"] = (None if ex is None
                          else ExecutionConfig.from_json(ex))
        return cls(**d)

    def summary(self) -> str:
        where = (f"mesh{self.axes_dict()}" if self.placement == "mesh"
                 else "single_host")
        return (f"BCPlan[{self.mode}] {where} backend={self.backend} "
                f"n_b={self.n_b} batches={self.n_batches} "
                f"~{self.predicted_seconds:.3g}s "
                f"~{self.predicted_comm_bytes:.3g}B comm "
                f"~{self.predicted_mem_bytes:.3g}B/dev")


def _near_square(q: int) -> Tuple[int, int]:
    """(data, model) with data·model = q, data ≥ model, as square as q allows."""
    model = 1
    for d in range(1, int(math.isqrt(q)) + 1):
        if q % d == 0:
            model = d
    return q // model, model


def _clamped_replication(n: int, m: int, p: int, mem_bytes: float) -> int:
    """Replication factor c: cost-model optimum, clamped to a divisor of p
    no larger than p^(1/3) (the Theorem 5.1 regime where replication pays)."""
    c_opt = best_replication(n, m, p, mem_bytes)
    cap = max(1, min(c_opt, int(round(p ** (1.0 / 3.0)))))
    c = 1
    for d in range(1, cap + 1):
        if p % d == 0:
            c = d
    return c


class BCPlanner:
    """Chooses backend, batch size and placement for a ``BCQuery``.

    ``calibration`` controls the measured step-time constants the regime
    choice and the ``predicted_*`` fields price with: the default
    ``"auto"`` loads the port's ``results/cost_calibration_torch.json``
    (or ``$REPRO_TORCH_BC_CALIBRATION``) fresh per plan, never the
    reference's file, while an explicit ``Calibration`` (tests, what-if
    planning) or ``None`` (force the analytic model) pins it.
    """

    def __init__(self, *, mem_bytes: float = 4 * 2 ** 30,
                 params: CostParams = DEFAULT,
                 calibration: Union[str, Calibration, None] = "auto"):
        self.mem_bytes = float(mem_bytes)
        self.params = params
        self._calibration = calibration

    @property
    def calibration(self) -> Optional[Calibration]:
        if isinstance(self._calibration, str):  # "auto"
            return load_calibration()
        return self._calibration

    # ------------------------------------------------------------------
    def plan(self, g: Graph, query, *, mesh=None,
             n_devices: Optional[int] = None, device="cuda") -> BCPlan:
        """Resolve ``query`` against the device topology.

        ``mesh``: an explicit ``launch.mesh.Mesh`` — pins placement (and
        axes) to it.
        ``n_devices``: topology override for planning without touching
        device state (tests, dry runs). Default: ``device_count(device)``.
        """
        if n_devices is None and mesh is None:
            n_devices = device_count(device)
        n, m = g.n, g.m
        pins = query.execution or ExecutionConfig()
        spec = metric_spec(query.metric)
        placement, axes, notes = self._placement(n, m, query, mesh,
                                                 n_devices)
        p = 1
        if axes is not None:
            for _, s in axes:
                p *= s

        # `g` may be a stats-only record (graphs.formats.GraphStats) with
        # no edge arrays — the out-of-core path plans before (or without
        # ever) materializing the COO arrays on this host.
        if query.weighted is not None:
            weighted = query.weighted
        elif hasattr(g, "w"):
            weighted = bool(np.any(g.w != 1.0))
        else:
            weighted = bool(getattr(g, "weighted", False))
        # n_b sizing hint: the *uncapped* a-priori budget (a max_samples cap
        # below it should not shrink the batch the hardware wants to run).
        hint = (n if query.mode == "exact"
                else hoeffding_budget(n, query.eps, query.delta))
        # `max_samples=0` is a real (degenerate) cap, not "no cap" — the
        # sampler honors it, so the plan's budget must too.
        cap = (1 << 62) if query.max_samples is None else query.max_samples
        budget = n if query.mode == "exact" else min(hint, cap)

        cal = self.calibration
        # est_iters feeds the frontier-occupancy-aware CSR rate (total
        # frontier work amortizes over the sweep's iterations), so it is
        # resolved *before* any regime call.
        est_iters = self._est_iters(n, weighted, query.iters)
        if spec.bounded:
            # a hop-bounded sweep runs exactly hops - 1 relax iterations
            est_iters = max(1, min(est_iters, query.hops - 1))
        backend = pins.backend
        if placement == "mesh":
            # the distributed step is dense-adjacency only
            backend = Backend.DENSE if backend is None else backend
            if backend != Backend.DENSE:
                raise ValueError(f"mesh placement supports only the dense "
                                 f"backend, got {backend.value!r}")
        elif backend is None:
            # Resolve the regime *before* sizing n_b: on graphs whose
            # dense adjacency busts the memory budget, sizing against the
            # dense model would reject every candidate and collapse n_b
            # to the minimum even though the COO executor has room.
            backend = Backend(choose_bc_regime(n, m, query.n_b or 64,
                                               fill=0.5, p=p,
                                               calibration=cal,
                                               est_iters=est_iters)["regime"])
        n_b = query.n_b or min(n, choose_sample_batch(
            n, m, p=p, backend=backend.value,
            mem_bytes=self.mem_bytes, budget_hint=hint,
            calibration=cal))
        regime = choose_bc_regime(n, m, n_b, fill=0.5, p=p, calibration=cal,
                                  est_iters=est_iters)

        # Kernel flag: an explicit pin wins; otherwise set where a
        # calibration *measured* the kernel variant faster. Recorded for
        # the plan's JSON only: the port's dense relaxes run the kernels
        # on the card and their plain versions on the CPU regardless.
        use_kernel = pins.use_kernel
        if use_kernel is None:
            use_kernel = bool(backend == Backend.DENSE and cal is not None
                              and cal.kernel_pays())

        # -- predictions (α-β cost layer, per device) -------------------
        if backend == Backend.DENSE:
            step_s = (regime["dense_kernel_s"]
                      if use_kernel and "dense_kernel_s" in regime
                      else regime["dense_s"])
        elif backend == Backend.CSR:
            # a calibrated regime may predate the CSR variant; price with
            # the COO rate then (an upper bound — CSR only sheds work)
            step_s = regime.get("csr_s", regime["coo_s"])
        else:
            step_s = regime["coo_s"]
        n_batches = -(-budget // n_b)
        if spec.fixed_point:
            # one whole-graph label fixed point, not per-source batches
            n_batches = 1
        state_nnz = _WORD * n_b * n  # one (n_b, n) f32 state matrix
        if placement == "mesh":
            c = dict(axes).get("pod", 1)
            # Theorem 5.1: (nnz(F) + 2·nnz(C))/√(p/c) per relax iteration
            comm_per_iter = 3.0 * state_nnz / max(math.sqrt(p / c), 1.0)
        else:
            comm_per_iter = 0.0
        # spec.sweeps relax sweeps of est_iters relaxations per batch:
        # MFBF + MFBr = 2 for betweenness, 1 for forward-only metrics —
        # the plan JSON records the metric next to this pricing.
        iters_total = spec.sweeps * est_iters * n_batches
        comm_bytes = comm_per_iter * iters_total
        # Calibrated fixed per-batch overhead (one device call per batch):
        # dispatch + host sync, the α of the measured α-β fit.
        overhead_s = (cal.overhead_seconds(backend, use_kernel=use_kernel)
                      if cal is not None
                      and cal.has(backend, use_kernel=use_kernel) else 0.0)
        seconds = (step_s * iters_total + overhead_s * n_batches
                   + self.params.cost(msgs=3.0 * iters_total, bytes_=comm_bytes))
        mem = self._mem_bytes(n, m, n_b, backend, placement, axes, p)

        execution = ExecutionConfig(backend=backend,
                                    use_kernel=bool(use_kernel),
                                    placement=placement, block=pins.block)
        return BCPlan(
            mode=query.mode, placement=placement, backend=backend.value,
            use_kernel=bool(use_kernel), n_b=int(n_b), block=pins.block,
            iters=query.iters, n_devices=p, mesh_axes=axes,
            sample_budget=int(budget), n_batches=int(n_batches),
            est_iters=int(est_iters), predicted_step_seconds=float(step_s),
            predicted_comm_bytes=float(comm_bytes),
            predicted_seconds=float(seconds), predicted_mem_bytes=float(mem),
            regime=regime, buckets=bucket_sizes(int(n_b)),
            tier=query.tier, metric=query.metric, hops=int(query.hops),
            execution=execution, notes=tuple(notes))

    # ------------------------------------------------------------------
    def _placement(self, n: int, m: int, query, mesh,
                   n_devices: Optional[int]):
        notes: List[str] = []
        pins = query.execution or ExecutionConfig()
        # Only betweenness has a distributed (Theorem 5.1) moments step;
        # sibling metrics run their sweeps single-host — never silently
        # when a topology was visible.
        if query.metric != "betweenness":
            if mesh is not None or pins.placement == "mesh":
                raise ValueError(
                    f"mesh placement is betweenness-only; metric "
                    f"{query.metric!r} has no distributed step")
            if n_devices > 1:
                note = (f"metric {query.metric!r} has no distributed step: "
                        f"planning single_host placement despite "
                        f"{n_devices} visible devices")
                notes.append(note)
            return "single_host", None, notes
        if mesh is not None:
            return "mesh", tuple(mesh.axis_sizes.items()), notes
        if pins.placement == "single_host":
            return "single_host", None, notes
        # A pinned COO/CSR backend has no distributed step — stay on one
        # host, but never silently: the caller asked for a topology the
        # backend cannot use, so the fallback is warned and carried on
        # plan.notes.
        if pins.backend in (Backend.COO, Backend.CSR):
            if pins.placement == "mesh":
                raise ValueError(
                    f"mesh placement supports only the dense backend; the "
                    f"{pins.backend.value.upper()} step is single-host only")
            if n_devices > 1:
                note = (f"pinned backend {pins.backend.value!r} has no "
                        f"distributed step: falling back to single_host "
                        f"placement despite {n_devices} visible devices")
                notes.append(note)
                warnings.warn(note, UserWarning, stacklevel=3)
            return "single_host", None, notes
        if n_devices <= 1:
            if pins.placement == "mesh":
                raise ValueError("mesh placement pinned but only one "
                                 "device is visible")
            return "single_host", None, notes
        c = _clamped_replication(n, m, n_devices, self.mem_bytes)
        data, model = _near_square(n_devices // c)
        axes = (("pod", c),) if c > 1 else ()
        return "mesh", axes + (("data", data), ("model", model)), notes

    @staticmethod
    def _est_iters(n: int, weighted: bool, iters: int) -> int:
        if iters > 0:
            return iters
        # small-world heuristic: O(log n) hops, stretched by edge weights
        base = max(8, 2 * int(math.log2(max(n, 2))) + 2)
        return min(n, base * (8 if weighted else 1))

    def _mem_bytes(self, n, m, n_b, backend, placement, axes, p) -> float:
        """Peak per-device footprint, from the shared adjacency/state
        memory model in ``approx.driver`` (mesh: A and Aᵀ sharded over
        the (data, model) grid and replicated over pods, state over p)."""
        if placement == "mesh":
            sizes = dict(axes)
            grid = sizes.get("data", 1) * sizes.get("model", 1)
            return (adjacency_bytes(n, m, backend="dense", p=grid,
                                    transpose=True)
                    + state_bytes(n, n_b, p=p))
        return (adjacency_bytes(n, m, backend=backend)
                + state_bytes(n, n_b))


_REQUEST_PLANNER = BCPlanner()


def plan_for_request(g: Graph, *, eps: float, delta: float,
                     rule: str = "normal", topk: Optional[int] = None,
                     max_samples: Optional[int] = None, seed: int = 0,
                     tier: Optional[str] = None,
                     metric: str = "betweenness", hops: int = 0,
                     execution: Optional[ExecutionConfig] = None,
                     iters: int = 0, mesh=None,
                     n_devices: Optional[int] = None, device="cuda",
                     planner: Optional[BCPlanner] = None) -> BCPlan:
    """Size an approximate-BC plan from one serving request's (ε, δ).

    The per-query half of the serving autotuning story: each request's
    accuracy contract flows through the α-β cost model — the (ε, δ)
    Hoeffding budget is the ``budget_hint`` that ``choose_sample_batch``
    sizes ``n_b`` against, so a loose-ε request plans a small first epoch
    and a tight-ε request a large one — and the plan records the
    power-of-two ``buckets`` its batches will run at. The cross-request
    half (packing several requests' demand into one fused batch) is
    ``repro_torch.bc.fusion.BatchAssembler``.

    ``tier`` names the request's latency tier (``bc.query.TIERS``); it
    does not change the configuration search, but it is recorded in the
    plan. ``execution`` pins part of the typed execution choice.
    """
    from repro_torch.bc.query import BCQuery

    # Fixed-point metrics (components) are exact by construction — the
    # (ε, δ) contract degenerates to "the answer", so the query plans in
    # exact mode while every sampled metric keeps the approx search.
    mode = "exact" if metric_spec(metric).fixed_point else "approx"
    q = BCQuery(mode=mode, eps=eps, delta=delta, rule=rule, topk=topk,
                max_samples=max_samples, seed=seed, tier=tier,
                metric=metric, hops=hops, execution=execution, iters=iters)
    return (planner or _REQUEST_PLANNER).plan(g, q, mesh=mesh,
                                              n_devices=n_devices,
                                              device=device)
