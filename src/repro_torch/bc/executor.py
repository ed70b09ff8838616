"""Executors — one batch-step protocol over the BC backends.

A port of ``repro/bc/executor.py`` for one device. A ``BatchExecutor``
turns a padded source batch into per-vertex dependency statistics through
three methods: ``step(sources, valid) -> (S1, S2, n_reach)`` with
``S1(v) = Σ_s δ_s(v)`` and ``S2(v) = Σ_s δ_s(v)²`` over the batch's valid
sources (what the sampling epochs call), ``step_sum(sources, valid) -> S1``
(the exact sweep's Σδ-only reduction), and ``step_segmented(sources, valid,
slot_ids, n_slots) -> (S1, S2, n_reach)`` shaped ``(n_slots, n)`` — the
cross-request fusion primitive: one batch packed from several concurrent
queries, summed per slot. Results are host numpy arrays (float64 moments,
int32 counts), as in the reference.

Shape bucketing: ``step`` / ``step_sum`` pad to the plan's ``n_b``
exactly, while ``step_segmented`` pads to the smallest power-of-two bucket
≥ the batch length (``plan.buckets``, see ``planner.bucket_sizes``). On
the card every bucket launches the kernels with the split count that
``n_b`` rows would get (``DenseAdj.for_batches``), and the segmented sum
folds each slot's rows in row order (``core.mfbc.segment_fold``), so a
slot's statistics are bitwise the same in any bucket.

What is ported: the ``BackendSpec`` registry with DENSE, COO and CSR
registered, and ``SingleHostExecutor`` for every registered metric: the
sampled metrics through ``step``/``step_sum``/``step_segmented`` (a fused
batch may mix metrics row-wise, ``metrics=``), the components fixed point
through ``labels()``, and the CSR occupancy side channel
(``occupancy_summary``) on the betweenness path; and ``MeshExecutor``,
the distributed Theorem 5.1 moments step of betweenness on a
(pod, data, model) mesh of ``torch.distributed`` ranks
(``core.dist_bc``), for a mesh plan. On the CSR backend,
as on COO, a slot's fused statistics stay bitwise those of its rows alone
because the segment sums add each segment in arc order, whatever the
batch's union frontier makes the bucket pick choose.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, ContextManager, Dict, Optional, \
    Protocol, Tuple, Union, runtime_checkable

import numpy as np
import torch

from repro_torch import resolve_device, tracing
from repro_torch.bc.config import Backend, as_backend
from repro_torch.bc.planner import BCPlan, bucket_sizes
from repro_torch.core.adjacency import (CsrAdj, coo_adj_from_graph,
                                        csr_adj_from_graph,
                                        dense_adj_from_graph)
from repro_torch.core.dist_bc import MeshBCContext
from repro_torch.core.mfbc import (metric_batch_moments,
                                   metric_batch_moments_segmented,
                                   mfbc_batch, mfbc_batch_moments,
                                   mfbc_batch_moments_segmented,
                                   mfbc_batch_moments_traced)
from repro_torch.core.metrics import components_graph, components_labels
from repro_torch.graphs.formats import Graph
from repro_torch.launch.mesh import Mesh

Moments = Tuple[np.ndarray, np.ndarray, np.ndarray]  # (S1, S2, n_reach)


# --- backend registry ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class BackendSpec:
    """How one ``Backend`` plugs into the executor layer.

    ``make_adjacency(g, plan, device)`` builds the device-resident
    adjacency the relax steps dispatch on; ``placements`` lists where the
    backend can run; ``supports_kernel`` says whether it has a kernel
    route.
    """

    backend: Backend
    make_adjacency: Callable[[Graph, BCPlan, torch.device], Any]
    placements: Tuple[str, ...] = ("single_host",)
    supports_kernel: bool = False


_BACKEND_REGISTRY: Dict[Backend, BackendSpec] = {}


def register_backend(spec: BackendSpec) -> BackendSpec:
    """Register (or replace) the executor-layer spec for a backend."""
    _BACKEND_REGISTRY[spec.backend] = spec
    return spec


def backend_spec(backend: Union[Backend, str]) -> BackendSpec:
    """Resolve a backend (enum or string) to its registered spec."""
    be = as_backend(backend)
    try:
        return _BACKEND_REGISTRY[be]
    except KeyError:
        raise ValueError(f"no executor registered for backend "
                         f"{be.value!r}") from None


def registered_backends() -> Tuple[Backend, ...]:
    return tuple(_BACKEND_REGISTRY)


register_backend(BackendSpec(
    backend=Backend.DENSE,
    # Fixed split count for every bucket up to n_b: a row's tie sums must
    # not depend on the bucket its batch runs at.
    make_adjacency=lambda g, plan, device: dense_adj_from_graph(
        g, block=plan.block, device=device).for_batches(plan.n_b),
    placements=("single_host", "mesh"),
    supports_kernel=True))

register_backend(BackendSpec(
    backend=Backend.COO,
    make_adjacency=lambda g, plan, device: coo_adj_from_graph(
        g, device=device),
    placements=("single_host",)))

register_backend(BackendSpec(
    backend=Backend.CSR,
    # The plan's n_b sizes the compaction capacity ladder
    # (core.adjacency.frontier_caps).
    make_adjacency=lambda g, plan, device: csr_adj_from_graph(
        g, n_b=plan.n_b, device=device),
    placements=("single_host",)))


@runtime_checkable
class BatchExecutor(Protocol):
    """The one surface both solve drivers (exact sweep, epochs) run over."""

    n_b: int  # effective batch size
    buckets: Tuple[int, ...]  # padded shapes served (ascending, max = n_b)
    plan: BCPlan

    def step(self, sources: np.ndarray, valid: np.ndarray, *,
             metric: str = "betweenness", hops: int = 0) -> Moments:
        """Per-vertex (Σδ, Σδ², n_reach) over the batch's valid sources."""
        ...

    def step_sum(self, sources: np.ndarray, valid: np.ndarray, *,
                 metric: str = "betweenness", hops: int = 0) -> np.ndarray:
        """Σδ only — the exact sweep's reduction."""
        ...

    def step_segmented(self, sources: np.ndarray, valid: np.ndarray,
                       slot_ids: np.ndarray, n_slots: int, *,
                       metrics=None, hops: int = 0) -> Moments:
        """Per-slot (Σδ, Σδ², n_reach), each ``(n_slots, n)``: row tags
        ``slot_ids ∈ [0, n_slots)`` say which query each source belongs
        to. Slot j's statistics are bitwise what a run of its rows alone
        (in the same order) gives on the same executor. Batches are padded
        to the smallest serving bucket, not ``n_b``."""
        ...

    def bucket_for(self, k: int) -> int:
        """The padded shape a k-source fused batch runs at."""
        ...


def _pad_batch(sources: np.ndarray, valid: np.ndarray, n_b: int):
    sources = np.asarray(sources, np.int32)
    valid = np.asarray(valid, bool)
    if sources.shape[0] > n_b:
        # Never truncate silently: dropped sources would bias any
        # estimator fed the full batch's n_valid.
        raise ValueError(f"batch of {sources.shape[0]} sources exceeds "
                         f"the executor's n_b={n_b}; split it or build "
                         f"an executor from a plan with a larger n_b")
    if sources.shape[0] == n_b:
        return sources, valid
    src = np.zeros(n_b, np.int32)
    val = np.zeros(n_b, bool)
    k = sources.shape[0]
    src[:k], val[:k] = sources[:k], valid[:k]
    return src, val


def _pad_segmented(sources, valid, slot_ids, bucket: int, pad_slot: int):
    """Pad a fused batch to its bucket; padding rows carry ``valid=False``
    and slot id ``pad_slot`` (the dump segment, dropped from the
    result)."""
    sources = np.asarray(sources, np.int32)
    valid = np.asarray(valid, bool)
    slot_ids = np.asarray(slot_ids, np.int32)
    if not (sources.shape == valid.shape == slot_ids.shape):
        raise ValueError("sources, valid and slot_ids must share one shape")
    k = sources.shape[0]
    if k == bucket:
        return sources, valid, slot_ids
    src = np.zeros(bucket, np.int32)
    val = np.zeros(bucket, bool)
    sid = np.full(bucket, pad_slot, np.int32)
    src[:k], val[:k], sid[:k] = sources, valid, slot_ids
    return src, val, sid


def _bucket_for(k: int, buckets: Tuple[int, ...], n_b: int) -> int:
    for b in buckets:
        if k <= b:
            return b
    raise ValueError(f"batch of {k} sources exceeds the executor's "
                     f"n_b={n_b}; split it (the BatchAssembler caps "
                     f"fused batches at executor capacity)")


def _slot_bucket(n_slots: int) -> int:
    """Segment-count bucket: next power of two ≥ n_slots. The reference
    buckets the slot dimension so that its compiled steps stay few; the
    port keeps the same padded shapes (the extra segments are empty and
    sliced off)."""
    b = 1
    while b < n_slots:
        b <<= 1
    return b


class _ExecutorBase:
    """Shared padding/bucketing half of every ``BatchExecutor``.

    Subclasses set ``plan`` / ``n_b`` / ``buckets`` in ``__init__`` and
    implement the three compute hooks; the base owns the shape contract
    (exact-``n_b`` padding for ``step``/``step_sum``, bucket and slot
    padding for ``step_segmented``).
    """

    plan: BCPlan
    n_b: int
    buckets: Tuple[int, ...]

    def bucket_for(self, k: int) -> int:
        return _bucket_for(k, self.buckets, self.n_b)

    def step(self, sources: np.ndarray, valid: np.ndarray, *,
             metric: str = "betweenness", hops: int = 0) -> Moments:
        src, val = _pad_batch(sources, valid, self.n_b)
        if metric == "betweenness":
            return self._moments(src, val)  # the default path, with its trace
        return self._metric_moments(src, val, metric, hops)

    def step_sum(self, sources: np.ndarray, valid: np.ndarray, *,
                 metric: str = "betweenness", hops: int = 0) -> np.ndarray:
        src, val = _pad_batch(sources, valid, self.n_b)
        if metric == "betweenness":
            return self._sum(src, val)
        return self._metric_moments(src, val, metric, hops)[0]

    def step_segmented(self, sources: np.ndarray, valid: np.ndarray,
                       slot_ids: np.ndarray, n_slots: int, *,
                       metrics=None, hops: int = 0) -> Moments:
        bucket = self.bucket_for(np.asarray(sources).shape[0])
        n_seg = _slot_bucket(n_slots)
        src, val, sid = _pad_segmented(sources, valid, slot_ids, bucket,
                                       n_seg)
        if metrics is None or all(m == "betweenness" for m in metrics):
            s1, s2, nr = self._segmented(src, val, sid, n_seg)
            return s1[:n_slots], s2[:n_slots], nr[:n_slots]
        if len(metrics) != n_slots:
            raise ValueError(f"metrics names {len(metrics)} slots, "
                             f"batch has {n_slots}")
        # kinds in first-appearance order and a kind tag per row; padding
        # rows tag kind 0 — they are valid=False and land in the dump
        # segment regardless.
        kinds = tuple(dict.fromkeys(metrics))
        slot_kind = np.array([kinds.index(m) for m in metrics]
                             + [0], np.int32)  # [-1] = the dump segment
        mids = slot_kind[np.minimum(sid, len(metrics))]
        s1, s2, nr = self._metric_segmented(src, val, sid, mids, kinds,
                                            n_seg, hops)
        return s1[:n_slots], s2[:n_slots], nr[:n_slots]

    # -- compute hooks (padded inputs, full padded outputs) -------------
    def _moments(self, src, val) -> Moments:
        raise NotImplementedError

    def _sum(self, src, val) -> np.ndarray:
        raise NotImplementedError

    def _segmented(self, src, val, sid, n_seg: int) -> Moments:
        raise NotImplementedError

    # -- metric-generic hooks (betweenness never routes through these) --
    def _metric_moments(self, src, val, metric: str, hops: int) -> Moments:
        raise NotImplementedError(
            f"{type(self).__name__} runs betweenness only; metric "
            f"{metric!r} sweeps are single-host")

    def _metric_segmented(self, src, val, sid, mids, kinds, n_seg: int,
                          hops: int) -> Moments:
        raise NotImplementedError(
            f"{type(self).__name__} runs betweenness only; metrics "
            f"{kinds!r} fuse single-host")

    def labels(self) -> np.ndarray:
        """The components fixed point: (n,) float64 labels."""
        raise NotImplementedError(
            f"{type(self).__name__} has no fixed-point metric entry "
            f"(components runs single-host)")


def _host(s1, s2, nr) -> Moments:
    tracing.count("host_syncs", 3)
    return (s1.cpu().numpy().astype(np.float64),
            s2.cpu().numpy().astype(np.float64), nr.cpu().numpy())


class SingleHostExecutor(_ExecutorBase):
    """One-device moments step on the plan's backend (dense blocked
    products, COO, or frontier-compacted CSR segment-op relax).

    ``device``: "cuda" (default; raises without a card) runs the Hopper
    kernels, "cpu" their plain versions. The adjacency is built once, on
    that device, from the plan's backend via the registry. A ``CsrAdj``
    adjacency routes betweenness ``step`` and ``step_sum`` through the
    traced moments entry point and accumulates the frontier occupancy side
    channel (``occupancy_summary``); other metrics run untraced, as in the
    reference. ``labels()`` builds a second adjacency, of the zero-weight
    symmetrized graph, on its first call. Each betweenness call is a
    ``batch`` span of ``repro_torch.tracing``, and each copy of a result to
    the host counts one ``host_syncs``.
    """

    def __init__(self, g: Graph, plan: BCPlan, *, device="cuda"):
        spec = backend_spec(plan.backend)
        self.device = resolve_device(device)
        self.plan = plan
        self.n_b = plan.n_b
        self.buckets = plan.buckets or bucket_sizes(plan.n_b)
        self._g = g
        self._adj = spec.make_adjacency(g, plan, self.device)
        # The occupancy trace is collected for the compacting adjacency
        # only; dense and COO moments run the untraced path.
        self._trace = isinstance(self._adj, CsrAdj)
        self._occ: Dict[str, Any] = {}
        self._cc_adj = None  # the components structure, built by labels()

    def _put(self, x: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(x).to(self.device)

    def _record_occupancy(self, tr_bf, tr_br) -> None:
        o = self._occ
        o["batches"] = o.get("batches", 0) + 1
        o["overflows"] = (o.get("overflows", 0) + tr_bf.overflows
                          + tr_br.overflows)
        o["compact_hits"] = (o.get("compact_hits", 0) + tr_bf.compact_hits
                             + tr_br.compact_hits)
        o["relax_calls"] = (o.get("relax_calls", 0) + tr_bf.iters
                            + tr_br.iters)
        o["hit_rate"] = o["compact_hits"] / max(o["relax_calls"], 1)

    def occupancy_summary(self):
        """Accumulated frontier-occupancy trace, or None when not traced:
        ``batches``, ``overflows``, ``compact_hits``, ``relax_calls`` and
        ``hit_rate`` over every traced batch this executor ran.
        """
        return dict(self._occ) if self._occ else None

    def _traced(self, src, val):
        s1, s2, nr, tr_bf, tr_br = mfbc_batch_moments_traced(
            self._adj, self._put(src), self._put(val))
        self._record_occupancy(tr_bf, tr_br)
        return s1, s2, nr

    def _batch(self, src):
        """The ``batch`` span of one call: uploads, body, fold and the
        copies to the host."""
        return tracing.span("batch", self.device, rows=src.shape[0],
                            n=self._adj.n)

    def _moments(self, src, val) -> Moments:
        with self._batch(src):
            if self._trace:
                return _host(*self._traced(src, val))
            return _host(*mfbc_batch_moments(self._adj, self._put(src),
                                             self._put(val)))

    def _sum(self, src, val) -> np.ndarray:
        with self._batch(src):
            if self._trace:
                # S1 of the moments IS λ_partial: the exact sweep rides the
                # traced path at the cost of one discarded elementwise
                # square.
                lam_b = self._traced(src, val)[0]
            else:
                lam_b, _, _ = mfbc_batch(self._adj, self._put(src),
                                         self._put(val))
            tracing.count("host_syncs")
            return lam_b.cpu().numpy().astype(np.float64)

    def _segmented(self, src, val, sid, n_seg: int) -> Moments:
        with self._batch(src):
            return _host(*mfbc_batch_moments_segmented(
                self._adj, self._put(src), self._put(val), sid,
                n_slots=n_seg))

    def _metric_moments(self, src, val, metric: str, hops: int) -> Moments:
        mids = torch.zeros(src.shape[0], dtype=torch.int32,
                           device=self.device)
        return _host(*metric_batch_moments(
            self._adj, self._put(src), self._put(val), mids,
            kinds=(metric,), hops=int(hops)))

    def _metric_segmented(self, src, val, sid, mids, kinds, n_seg: int,
                          hops: int) -> Moments:
        return _host(*metric_batch_moments_segmented(
            self._adj, self._put(src), self._put(val), sid, self._put(mids),
            kinds=kinds, n_slots=n_seg, hops=int(hops)))

    def labels(self) -> np.ndarray:
        if self._cc_adj is None:
            self._cc_adj = backend_spec(self.plan.backend).make_adjacency(
                components_graph(self._g), self.plan, self.device)
        return components_labels(self._cc_adj).cpu().numpy().astype(
            np.float64)


class MeshExecutor(_ExecutorBase):
    """Distributed Theorem 5.1 moments step on a (pod, data, model) mesh.

    Every rank of the mesh builds one and calls it with the same batches;
    each call returns the same host arrays on every rank. ``mesh=None``
    builds the mesh the plan chose (``plan.mesh_axes``) over the
    initialized process group, on ``device``. All variants and buckets
    share one lazily built ``MeshBCContext``: the padded, permuted
    adjacency is uploaded once, and the kernels' split count is fixed
    for every bucket (``MeshBCContext.for_batches``).

    Serving on a mesh (``serve.BCService(mesh=)``): requests reach rank 0
    only, so rank 0 sets ``mirror`` and each batch the executor has
    checked and padded runs inside ``with mirror(hook, args):``, which
    hands it to the other ranks before its collectives start; they run
    it with ``replay(hook, args)`` on their own executor, built from
    rank 0's plan. A call the executor refuses (a metric other than
    betweenness, ``labels()``, a batch over ``n_b``) raises before
    ``mirror`` sees it, and so does a failure of rank 0's lazy context
    upload, which needs no collective. Each call is a ``batch`` span of
    ``repro_torch.tracing`` (rows, n), as on the single host.
    """

    HOOKS = ("_moments", "_sum", "_segmented")  # what ``replay`` runs
    mirror: Optional[Callable[[str, tuple], ContextManager]] = None

    def __init__(self, g: Graph, plan: BCPlan, mesh=None, *, device="cuda"):
        if mesh is None:
            axes = plan.axes_dict()
            if axes is None:
                raise ValueError("plan has no mesh_axes and no mesh given")
            mesh = Mesh(tuple(axes.values()), tuple(axes), device=device)
        self.plan = plan
        self.mesh = mesh
        self._g = g
        # Lazy context: an executor built for planning introspection never
        # pads or uploads the adjacency.
        self._ctx = None
        # MeshBCContext's batch rounding (sources are sharded over
        # pod×data), computed up front so callers can size sample batches
        # before any device work happens.
        sizes = mesh.axis_sizes
        chunk = sizes.get("pod", 1) * sizes.get("data", 1)
        self.n_b = -(-plan.n_b // chunk) * chunk
        # Bucket set: the plan's power-of-two shapes, each rounded up to
        # the mesh divisibility (dedup keeps them ascending).
        rounded = [-(-b // chunk) * chunk
                   for b in (plan.buckets or bucket_sizes(plan.n_b))]
        rounded.append(self.n_b)
        self.buckets = tuple(sorted({min(b, self.n_b) for b in rounded}))

    def _context(self) -> MeshBCContext:
        if self._ctx is None:
            self._ctx = MeshBCContext(self._g, self.mesh,
                                      iters=self.plan.iters
                                      ).for_batches(self.n_b)
        return self._ctx

    def _mirrored(self, hook: str, *args) -> ContextManager:
        return (contextlib.nullcontext() if self.mirror is None
                else self.mirror(hook, args))

    def replay(self, hook: str, args: tuple):
        """Run a call another rank's ``mirror`` announced: ``hook`` (one
        of ``HOOKS``) on its checked, padded arguments."""
        if hook not in self.HOOKS:
            raise ValueError(f"replay runs one of {self.HOOKS}, got "
                             f"{hook!r}")
        return getattr(self, hook)(*args)

    def _batch(self, src):
        """The ``batch`` span of one call: uploads, the distributed body,
        the statistics' collectives and their copy to the host."""
        return tracing.span("batch", self.mesh.device, rows=src.shape[0],
                            n=self._g.n)

    def _moments(self, src, val) -> Moments:
        ctx = self._context()
        with self._batch(src), self._mirrored("_moments", src, val):
            return ctx.run_moments(src, val, nb=self.n_b)

    def _sum(self, src, val) -> np.ndarray:
        ctx = self._context()
        with self._batch(src), self._mirrored("_sum", src, val):
            return ctx.run_sum(src, val, nb=self.n_b)

    def _segmented(self, src, val, sid, n_seg: int) -> Moments:
        ctx = self._context()
        with self._batch(src), self._mirrored("_segmented", src, val, sid,
                                              n_seg):
            return ctx.run_segmented(src, val, sid, n_seg, nb=src.shape[0])


def build_executor(g: Graph, plan: BCPlan, *, mesh=None,
                   device="cuda") -> BatchExecutor:
    """Instantiate the executor a ``BCPlan`` calls for, on ``device``.

    A mesh plan (or an explicit ``mesh``) builds a ``MeshExecutor``, on
    the mesh's device when one is given; a mesh plan on a backend with no
    mesh step raises ``ValueError`` (a planner bug, never a fallback).
    """
    spec = backend_spec(plan.backend)
    if plan.placement == "mesh" or mesh is not None:
        if "mesh" not in spec.placements:
            raise ValueError(f"backend {spec.backend.value!r} has no mesh "
                             f"step (placements: {spec.placements})")
        return MeshExecutor(g, plan, mesh=mesh, device=device)
    return SingleHostExecutor(g, plan, device=device)
