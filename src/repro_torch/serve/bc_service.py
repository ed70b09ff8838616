"""Top-k central-vertices serving endpoint over approximate BC.

The request/response scheduling is ``repro.serve.engine.ServeEngine``'s: a
fixed pool of ``n_slots`` concurrently progressing jobs, an admission
queue, and a host-side ``step()`` tick that advances active slots by
units of work — here *sampling epochs* of the adaptive approximate-BC
driver instead of decode tokens. Long-running queries (tight ε on a big
graph) therefore never block short ones (loose ε / top-k early exit): a
slot frees the moment its estimator converges.

Graphs are registered up front (like model weights); the
``repro_torch.bc`` planner resolves each one to a capacity ``BCPlan`` and
a shared ``BatchExecutor`` — the adjacency resident on ``device`` and the
card's kernels (their plain versions on the CPU) — reused by every
request that names the graph. On top of that per-graph amortization the
tick loop runs the per-query optimizations of the serving stack:

* **per-request planning** — each distinct (graph, ε, δ, rule, tier)
  resolves its own ``BCPlan`` through ``repro_torch.bc.plan_for_request``
  (cached), so a loose-ε request samples small epochs instead of
  inheriting the graph-wide batch size;
* **cross-request fusion** — active slots are grouped by graph each
  tick and their epoch demand is drained through one
  ``repro_torch.bc.BatchAssembler`` into slot-tagged fused batches for
  the executor's ``step_segmented``: several under-filled per-request
  batches become one padded batch, paying the step's fixed cost (kernel
  launches and host reads) once per batch instead of once per request. A
  lone request whose batch size matches the executor's runs the classic
  per-request path, so single-query service answers are bit-identical to
  ``repro_torch.bc.solve``'s driver run over the same source stream;
* **QoS scheduling** — requests carry a latency tier (``priority`` ∈
  ``repro_torch.bc.TIERS``, or an explicit ``deadline_s``) and both
  admission and demand draining are deadline-aware:
  admission is earliest-deadline-first over *absolute* deadlines
  (``pack="fifo"`` restores strict submit order), which is also the
  aging rule — a queued batch-tier request's fixed deadline eventually
  undercuts every newly arriving interactive one, so loose work is
  never starved; draining orders each tick's ``(slot, sources)``
  demand through ``repro_torch.bc.order_demand`` (deadline slack or
  per-tenant fair share) and, under a ``tick_budget``, drains
  *partially*: a tight-ε burst preempts loose-ε slots mid-epoch, whose
  remaining chunks are deferred to the next tick. Deferral is safe:
  the sampler's demand/assembly split draws each epoch's sources once
  up front (``AdaptiveSampler.draw`` is chunking-invariant), so a
  deferred chunk is the same sources it would have been undeferred.

Each admitted request samples its own RNG stream derived from
``(seed, rid)`` — two concurrent requests that share a seed (e.g. both
left it at the default 0) still draw independent source streams, so
their (ε, δ) guarantees and top-k answers stay independent. To
reproduce a request exactly, resubmit it with the same ``seed`` *and*
``rid``.

``fuse=False`` disables per-request planning and fusion (the
pre-fusion behavior).

A copy of ``repro.serve.bc_service`` over the port. It differs in
interface only: ``device`` ("cuda" by default, raising without a card, or
"cpu") is where every executor of the service runs; on a mesh of
``torch.distributed`` ranks (``mesh=``) every rank constructs the service,
rank 0 serves and the others call ``follow()`` until rank 0's ``close()``
(below); the deprecated ``backend=`` keyword is gone (pass
``execution=``). The module imports only public ``repro_torch.bc`` names,
which ``tests/test_torch_imports.py`` checks.

Serving on a mesh. The reference's mesh lives in one process; the port's
is a set of ranks, and every collective needs every rank while requests
reach rank 0 only. So rank 0 mirrors its executors: each batch a graph's
``MeshExecutor`` has checked and padded is broadcast to the other ranks
(the graph's name, the call and its numpy arguments; the first message
of a graph also carries rank 0's ``BCPlan``) on a gloo control group
before its collectives start, and each other rank runs the same call on
its own executor, built from that plan. Ticks, fused or not, the
gateway's refines and the lazy adjacency upload all go through these
calls. Calls the executor refuses raise on rank 0 before anything is
sent. Constructing a mesh service is collective (it creates the control
group), so every rank constructs its services in the same order::

    svc = BCService(graphs, mesh=mesh, checkpoints=True)
    if mesh.rank == 0:
        try:
            ...                      # serve: a gateway, svc.run(), ...
        finally:
            svc.close()              # the followers' stop message
    else:
        svc.follow()                 # returns on rank 0's close()

The control group's timeout is ``ctrl_timeout`` (torch's gloo default when
None). A follower never waits for rank 0's next message longer than it:
while no call is in flight, rank 0 sends a keep-alive every quarter of
it, which ``follow()`` skips, so an idle server keeps its followers for
as long as it serves. The followers call ``follow()`` right after they
construct the service. An exception in a mirrored call is not caught,
and ends ``follow()`` on that rank.
"""
from __future__ import annotations

import contextlib
import dataclasses
import datetime
import functools
import math
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device, tracing
from repro_torch.bc import (PACKS, TIER_DEADLINE_S, TIERS, AdaptiveSampler,
                            ApproxCheckpoint, BatchAssembler, BatchExecutor,
                            BCPlan, BCQuery, ExecutionConfig,
                            LambdaEstimator, build_executor, checkpoint_from,
                            fuse_group, honest_converged, metric_spec,
                            order_demand, plan_for_request, scatter)
from repro_torch.bc import plan as bc_plan
from repro_torch.bc import stopping_check
from repro_torch.graphs.formats import Graph, graph_digest

_BEAT = "beat"  # rank 0's keep-alive on the control group; follow() skips it


def _mesh_device(mesh, device):
    """A mesh service runs on its mesh's device; ``device``, when given,
    must name it."""
    if device is not None:
        dev = torch.device(device)
        if dev.type != mesh.device.type or dev.index not in (
                None, mesh.device.index):
            raise ValueError(f"BCService(mesh=) runs on the mesh's device "
                             f"{mesh.device}, got device={device!r}")
    return mesh.device


@dataclasses.dataclass
class BCRequest:
    """One top-k BC query.

    ``priority`` names the latency tier (``repro_torch.bc.TIERS``); the
    scheduler turns it into an absolute deadline of ``submit_time +
    deadline_s`` (tier default from ``repro_torch.bc.TIER_DEADLINE_S``
    unless ``deadline_s`` is given). ``tenant`` feeds the ``pack="fair"``
    drain policy. The served source stream is derived from
    ``(seed, rid)`` — identical requests with distinct rids draw
    independent streams; same (seed, rid) reproduces exactly.
    """

    rid: int
    graph: str  # registered graph name
    k: int = 10  # top-k query size
    eps: float = 0.05
    delta: float = 0.1
    rule: str = "normal"
    seed: int = 0
    max_samples: Optional[int] = None  # hard cap under the Hoeffding budget
    priority: str = "normal"  # latency tier, one of repro_torch.bc.TIERS
    deadline_s: Optional[float] = None  # None = the tier's default
    tenant: str = "default"  # fair-share accounting key
    metric: str = "betweenness"  # repro_torch.bc.registered_metrics()
    hops: int = 0  # hop bound, required (>=1) for bounded metrics only

    def __post_init__(self) -> None:
        if self.priority not in TIERS:
            raise ValueError(f"priority must be one of {TIERS}, "
                             f"got {self.priority!r}")
        # Same metric validation as BCQuery, but at request construction
        # — a bad metric must 400 at submit, not explode ticks later
        # inside _plan_for_request.
        spec = metric_spec(self.metric)
        if spec.bounded:
            if self.hops < 1:
                raise ValueError(f"metric {self.metric!r} needs hops >= 1, "
                                 f"got {self.hops}")
        elif self.hops:
            raise ValueError(f"hops only applies to hop-bounded metrics, "
                             f"not {self.metric!r}")
        # rid and seed feed np.random.SeedSequence entropy (the per-job
        # stream is derived from (seed, rid)), which rejects negatives —
        # fail at construction, not ticks later inside _admit.
        if self.rid < 0 or self.seed < 0:
            raise ValueError(f"rid and seed must be non-negative (they "
                             f"seed the job's RNG stream), got rid="
                             f"{self.rid} seed={self.seed}")


@dataclasses.dataclass
class BCResponse:
    rid: int
    graph: str
    topk: List[int]
    lam: np.ndarray  # (k,) estimates for the top-k ids
    halfwidth: np.ndarray  # (k,) CI halfwidths (λ scale)
    n_samples: int
    n_epochs: int
    converged: bool
    seconds: float  # admission -> retirement (service time)
    plan: Optional[BCPlan] = None  # the per-request plan that sized the run
    tier: str = "normal"  # the request's latency tier
    latency_s: float = 0.0  # submit -> retirement (what QoS is measured on)
    digest: Optional[str] = None  # content digest of the graph served
    # resumable (S1, S2, τ) estimator state, attached only when the
    # service runs with checkpoints=True (the result cache's refine
    # path). Host-side only — never serialized onto the wire.
    checkpoint: Optional[ApproxCheckpoint] = None
    # (n_samples,) int32: the sources the estimate swept, in the order
    # they drained (None for fixed-point metrics, which sample nothing).
    # Host-side only, like ``checkpoint``.
    sources: Optional[np.ndarray] = None

    def to_json(self) -> Dict:
        """JSON wire form (the gateway's result payload).

        Every numpy scalar/array is converted to a plain Python value —
        ``json.dumps`` on dataclass fields would otherwise choke on the
        ``np.float64``/``np.int64`` leaking out of the estimator — and
        Python's shortest-repr float serialization round-trips each
        float64 *exactly*, so cached payloads compare bitwise. The
        ``checkpoint`` and ``sources`` (host-side numpy state) stay off
        the wire.
        """
        return {
            "rid": int(self.rid),
            "graph": str(self.graph),
            "topk": [int(v) for v in self.topk],
            "lam": [float(x) for x in np.asarray(self.lam)],
            "halfwidth": [float(x) for x in np.asarray(self.halfwidth)],
            "n_samples": int(self.n_samples),
            "n_epochs": int(self.n_epochs),
            "converged": bool(self.converged),
            "seconds": float(self.seconds),
            "plan": self.plan.to_json() if self.plan is not None else None,
            "tier": str(self.tier),
            "latency_s": float(self.latency_s),
            "digest": self.digest,
        }

    @classmethod
    def from_json(cls, d: Dict) -> "BCResponse":
        """Inverse of ``to_json`` (float64 arrays restored bit-exactly)."""
        plan = d.get("plan")
        return cls(
            rid=int(d["rid"]), graph=d["graph"],
            topk=[int(v) for v in d["topk"]],
            lam=np.asarray(d["lam"], dtype=np.float64),
            halfwidth=np.asarray(d["halfwidth"], dtype=np.float64),
            n_samples=int(d["n_samples"]), n_epochs=int(d["n_epochs"]),
            converged=bool(d["converged"]), seconds=float(d["seconds"]),
            plan=None if plan is None else BCPlan.from_json(plan),
            tier=d.get("tier", "normal"),
            latency_s=float(d.get("latency_s", 0.0)),
            digest=d.get("digest"))


@dataclasses.dataclass
class _Queued:
    """Admission-queue entry: absolute deadline + arrival order."""

    deadline: float  # absolute, on the monotonic clock
    seq: int  # arrival order (FIFO key / EDF tie-break)
    t_submit: float
    req: BCRequest


@dataclasses.dataclass
class _Job:
    req: BCRequest
    sampler: AdaptiveSampler
    est: LambdaEstimator
    plan: BCPlan  # per-request plan (plan_for_request, cached)
    t0: float  # admission time
    t_submit: float
    deadline: float  # absolute
    seq: int  # arrival order (the FIFO drain key — slot indices recycle)
    n_epochs: int = 0
    # -- partial-drain state: the epoch currently draining ----------------
    epoch_idx: Optional[int] = None  # index of the epoch backlog belongs to
    backlog: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int32))
    swept: List[np.ndarray] = dataclasses.field(default_factory=list)


class BCService:
    """Slot-scheduled approximate-BC query service with QoS tiers.

    The ``repro_torch.bc`` planner places each graph on one ``device``
    ("cuda", the default, or "cpu"); every executor of the service is
    built there. With a ``launch.mesh.Mesh`` (``mesh=``) every registered
    graph's executor is the distributed moments step instead, on the
    mesh's device (a different ``device`` raises): rank 0 serves, every
    other rank calls ``follow()``, and rank 0's ``close()`` stops them
    (the module docstring); ``ctrl_timeout`` is the control group's
    timeout. ``iters`` bounds the mesh step's sweeps
    (0 = graph size) and is recorded in the plans, as in the reference.
    Per-graph capacity plans are inspectable via ``plan_for(name)``,
    per-request plans via the ``plan`` field of each ``BCResponse``.

    ``pack`` picks the scheduling policy (``repro_torch.bc.PACKS``):
    ``"deadline"`` (default) admits earliest-absolute-deadline-first and
    drains each tick's demand tightest-slack-first; ``"fair"`` balances
    drained rows across request tenants; ``"fifo"`` is the legacy
    strict-arrival-order behavior. With all-default requests (one tier,
    no explicit deadlines) every policy degenerates to FIFO, so tiering
    is strictly opt-in. ``tick_budget`` caps the source samples executed
    per tick: when set, low-priority slots mid-epoch are *preempted* —
    their remaining sources are deferred to later ticks while
    tight-deadline demand drains first.

    ``run`` never drops work silently: if ``max_ticks`` expires with
    requests still queued or active, ``exhausted`` is True and
    ``pending`` lists every unfinished request.
    """

    def __init__(self, graphs: Dict[str, Graph], *, n_slots: int = 4,
                 execution: Optional[ExecutionConfig] = None, mesh=None,
                 iters: int = 0, fuse: bool = True, pack: str = "deadline",
                 tick_budget: Optional[int] = None,
                 checkpoints: bool = False, device=None,
                 ctrl_timeout: Optional[datetime.timedelta] = None):
        if pack not in PACKS:
            raise ValueError(f"pack must be one of {PACKS}, got {pack!r}")
        if tick_budget is not None and tick_budget <= 0:
            raise ValueError(f"tick_budget must be positive or None, "
                             f"got {tick_budget}")
        self.mesh = mesh
        self.device = (resolve_device("cuda" if device is None else device)
                       if mesh is None else _mesh_device(mesh, device))
        # Without a mesh the service runs on its one device, however many
        # cards the host has: a mesh of ranks is only ever the caller's.
        self._n_devices = 1 if mesh is None else None
        # On a card the epoch-boundary tests run there, the host's numpy
        # passes over the whole graph left to the CPU path (the same
        # decisions: ``approx.driver.stopping_check``).
        self._check_device = (self.device if self.device.type == "cuda"
                              else None)
        # Mesh serving: the control group rank 0 mirrors its executors'
        # calls on (host objects, whatever the mesh's data backend), the
        # graphs already announced to the followers, rank 0's count of
        # mirrored calls, and its keep-alive thread, which
        # sends while nothing else has been sent for a quarter of the
        # group's timeout.
        self._ctrl = None
        self._announced: set = set()
        self._ctrl_lock = threading.Lock()
        self._closed = False
        self._last_sent = time.monotonic()
        self._stop_beats = threading.Event()
        self._beats: Optional[threading.Thread] = None
        self.mirrored = 0
        if mesh is not None:
            timeout = (dist.default_pg_timeout if ctrl_timeout is None
                       else ctrl_timeout)
            self._ctrl = dist.new_group(backend="gloo", timeout=timeout)
            self._beat_s = timeout.total_seconds() / 4
            if mesh.rank == 0 and dist.get_world_size(self._ctrl) > 1:
                self._beats = threading.Thread(
                    target=self._keep_alive, daemon=True,
                    name="bc-service-keep-alive")
                self._beats.start()
        # Registration accepts a plain Graph or a (Graph, digest) pair —
        # a caller that already holds the content digest passes it, so
        # serve does not recompute it; graphs registered without one get
        # graph_digest() lazily on first use. Either way the digest is
        # the result cache's key.
        self.graphs: Dict[str, Graph] = {}
        self._digests: Dict[str, Optional[str]] = {}
        for name, val in graphs.items():
            if isinstance(val, tuple):
                g, dg = val
            else:
                g, dg = val, None
            self.graphs[name] = g
            self._digests[name] = dg
        self.execution = execution
        self.checkpoints = checkpoints
        self.iters = iters
        self.n_slots = n_slots
        self.fuse = fuse
        self.pack = pack
        self.tick_budget = tick_budget
        self.slots: List[Optional[_Job]] = [None] * n_slots
        self.queue: List[_Queued] = []
        self.finished: List[BCResponse] = []
        self.exhausted = False  # run() hit max_ticks with work pending
        self._seq = 0
        self._served: Dict[str, int] = {}  # tenant -> rows drained (fair)
        self._executors: Dict[str, BatchExecutor] = {}
        self._assemblers: Dict[str, BatchAssembler] = {}
        self._request_plans: Dict[Tuple, BCPlan] = {}

    # ------------------------------------------------------------------
    def submit(self, req: BCRequest) -> None:
        if req.graph not in self.graphs:
            raise KeyError(f"unknown graph {req.graph!r}")
        # Monotonic clock throughout: deadlines, slack, and latencies are
        # only ever compared/subtracted internally, and a wall-clock step
        # (NTP) must not reorder EDF or produce negative latencies.
        t = time.monotonic()
        horizon = (req.deadline_s if req.deadline_s is not None
                   else TIER_DEADLINE_S[req.priority])
        self.queue.append(_Queued(deadline=t + horizon, seq=self._seq,
                                  t_submit=t, req=req))
        self._seq += 1

    def _graph_executor(self, name: str) -> BatchExecutor:
        """Capacity plan + executor per registered graph, built lazily,
        shared by every request that names the graph. Fused batches are
        capped at this executor's ``n_b``; per-request (ε, δ) sizing
        happens in ``_plan_for_request`` on top."""
        if name not in self._executors:
            if self.mesh is not None and self.mesh.rank != 0:
                raise RuntimeError(
                    f"rank {self.mesh.rank} of a mesh service runs rank "
                    f"0's calls: call follow(), serve on rank 0")
            g = self.graphs[name]
            pl = bc_plan(g, BCQuery(mode="approx", execution=self.execution,
                                    iters=self.iters), mesh=self.mesh,
                         n_devices=self._n_devices, device=self.device)
            ex = build_executor(g, pl, mesh=self.mesh, device=self.device)
            if self.mesh is not None:
                ex.mirror = functools.partial(self._announce, name)
            self._executors[name] = ex
        return self._executors[name]

    def _assembler(self, name: str) -> BatchAssembler:
        # pack="fifo" on purpose: step() already fixed the tick's drain
        # order (order_demand over ALL graphs, before the budget cut),
        # and each graph's demand arrives here in that order — re-sorting
        # inside the assembler would re-run the policy on a mid-tick
        # ``_served`` snapshot and could disagree with the schedule that
        # allocated the budget.
        if name not in self._assemblers:
            self._assemblers[name] = BatchAssembler(
                self._graph_executor(name))
        return self._assemblers[name]

    def _plan_for_request(self, req: BCRequest) -> BCPlan:
        """Per-request configuration search, cached by what sizes (or
        tags) it: requests sharing (graph, ε, δ, rule, cap, tier,
        metric, hops) share one plan."""
        key = (req.graph, req.eps, req.delta, req.rule, req.max_samples,
               req.priority, req.metric, req.hops)
        if key not in self._request_plans:
            self._request_plans[key] = plan_for_request(
                self.graphs[req.graph], eps=req.eps, delta=req.delta,
                rule=req.rule, max_samples=req.max_samples,
                tier=req.priority, execution=self.execution,
                iters=self.iters, mesh=self.mesh,
                n_devices=self._n_devices, device=self.device,
                metric=req.metric, hops=req.hops)
        return self._request_plans[key]

    def plan_for(self, name: str):
        """The capacity ``BCPlan`` serving this graph (builds the
        executor)."""
        return self._graph_executor(name).plan

    # ------------------------------------------------------- mesh serving
    @contextlib.contextmanager
    def _announce(self, name: str, hook: str, args: tuple):
        """Rank 0: send one checked executor call of graph ``name`` to the
        followers (the graph's plan with its first call), then run it here
        (the ``with`` body) under the control lock, so that no keep-alive
        is sent while the followers are inside the call."""
        plan = (None if name in self._announced
                else self._executors[name].plan.to_json())
        with self._ctrl_lock:
            if self._closed:
                raise RuntimeError("this mesh service is closed: its "
                                   "followers have returned")
            dist.broadcast_object_list([(name, hook, args, plan)], src=0,
                                       group=self._ctrl)
            self.mirrored += 1
            self._announced.add(name)
            try:
                yield
            finally:
                self._last_sent = time.monotonic()

    def _keep_alive(self) -> None:
        """Rank 0's keep-alive thread: between calls, send ``_BEAT``
        whenever nothing was sent for ``_beat_s``, until ``close()``."""
        while not self._stop_beats.wait(self._beat_s):
            with self._ctrl_lock:
                if self._closed:
                    return
                if time.monotonic() - self._last_sent >= self._beat_s:
                    dist.broadcast_object_list([_BEAT], src=0,
                                               group=self._ctrl)
                    self._last_sent = time.monotonic()

    def follow(self) -> int:
        """Every rank but 0 of a mesh service: run rank 0's executor calls
        on this rank's own executors until rank 0's ``close()``; the
        results (identical to rank 0's) are dropped. Returns the number of
        calls run."""
        if self.mesh is None or self.mesh.rank == 0:
            raise RuntimeError("follow() runs on the ranks other than 0 of "
                               "a mesh service; rank 0 serves")
        calls = 0
        while True:
            msg = [None]
            dist.broadcast_object_list(msg, src=0, group=self._ctrl)
            if msg[0] is None:
                return calls
            if msg[0] == _BEAT:
                continue
            name, hook, args, plan = msg[0]
            if plan is not None:
                self._executors[name] = build_executor(
                    self.graphs[name], BCPlan.from_json(plan),
                    mesh=self.mesh, device=self.device)
            self._executors[name].replay(hook, args)
            calls += 1

    def close(self) -> None:
        """Rank 0 of a mesh service: send the followers their stop message
        (once; call it in a ``finally``). Without a mesh, nothing to do."""
        if self.mesh is None:
            return
        if self.mesh.rank != 0:
            raise RuntimeError("close() runs on rank 0 of a mesh service; "
                               "the other ranks return from follow()")
        # Under the lock: a gateway worker still inside a tick either sent
        # its call before the stop message, or raises instead of sending.
        with self._ctrl_lock:
            if not self._closed:
                self._closed = True
                dist.broadcast_object_list([None], src=0, group=self._ctrl)
        self._stop_beats.set()
        if self._beats is not None:
            self._beats.join()

    # ------------------------------------------------- public introspection
    def executor_for(self, name: str) -> BatchExecutor:
        """The shared per-graph executor (the gateway's refine path runs
        ``repro_torch.bc.resume_approx`` through it, so refined and
        scratch answers execute on the same kernels + device adjacency)."""
        return self._graph_executor(name)

    def request_plan(self, req: BCRequest) -> BCPlan:
        """The per-request ``BCPlan`` a request would be sized by (what
        ``BCResponse.plan`` will carry) — the gateway prices admission
        decisions off its ``predicted_seconds`` *before* submitting."""
        return (self._plan_for_request(req) if self.fuse
                else self._graph_executor(req.graph).plan)

    def progress(self, rid: int) -> Optional[List[Tuple[int, float]]]:
        """Epoch-by-epoch ``(τ, max normalized halfwidth)`` history of an
        *active* request — the streaming partial-results hook the
        gateway's poll endpoint exposes while a job is still running.
        Returns ``None`` when no active slot carries the rid (queued, or
        already finished — the final answer supersedes partials)."""
        for job in self.slots:
            if job is not None and job.req.rid == rid:
                return list(job.est.hw_history)
        return None

    def digest(self, name: str) -> Optional[str]:
        """Content digest of a registered graph (the cache-key identity).

        Returns the digest supplied at registration, else computes
        ``graphs.formats.graph_digest`` once and
        caches it. Stats-only registrations (``GraphStats``) carry their
        own digest field; without one — no edge arrays to hash — this
        stays ``None`` and cache-backed serving is off for that graph.
        """
        if self._digests.get(name) is None:
            g = self.graphs[name]
            if getattr(g, "digest", None):
                self._digests[name] = g.digest
            elif hasattr(g, "src"):
                self._digests[name] = graph_digest(g)
        return self._digests.get(name)

    def describe_graph(self, name: str) -> Dict:
        """One registry row (the gateway's ``GET /v1/graphs`` record)."""
        g = self.graphs[name]
        return {"name": name, "n": int(g.n), "m": int(g.m),
                "digest": self.digest(name),
                "plan": self.plan_for(name).to_json()}

    # ------------------------------------------------------- admission
    def _pop_next(self) -> _Queued:
        """Next request to admit: earliest absolute deadline (EDF) with
        arrival-order tie-break, or strict arrival order for
        ``pack="fifo"``. EDF over absolute deadlines is also the aging
        rule — a queued loose-tier request's deadline is fixed while
        newly submitted tight-tier deadlines keep moving forward, so
        after at most its own deadline horizon the loose request sorts
        first and cannot be starved."""
        if self.pack == "fifo":
            j = min(range(len(self.queue)), key=lambda k: self.queue[k].seq)
        else:
            j = min(range(len(self.queue)),
                    key=lambda k: (self.queue[k].deadline, self.queue[k].seq))
        return self.queue.pop(j)

    def _finish_fixed_point(self, q: _Queued) -> None:
        """Answer a fixed-point metric (components) at admission time.

        A label fixed point is one whole-graph sweep with no sampling
        epochs, so there is nothing for a slot to advance tick by tick —
        running it inline keeps the slot pool for the queries that need
        incremental progress. The labels land in the response's ``lam``
        channel (value = component id), halfwidths are exactly zero and
        ``converged`` is True by construction.
        """
        req = q.req
        t0 = time.monotonic()
        ex = self._graph_executor(req.graph)
        pl = (self._plan_for_request(req) if self.fuse else ex.plan)
        lam = ex.labels()
        ids = np.argsort(lam)[::-1][:req.k]
        now = time.monotonic()
        self.finished.append(BCResponse(
            rid=req.rid, graph=req.graph, topk=[int(v) for v in ids],
            lam=lam[ids], halfwidth=np.zeros(ids.shape[0]),
            n_samples=int(self.graphs[req.graph].n), n_epochs=1,
            converged=True, seconds=now - t0, plan=pl,
            tier=req.priority, latency_s=now - q.t_submit,
            digest=self.digest(req.graph)))
        tracing.count("serve.retired")

    def _admit(self) -> None:
        # Fixed-point metrics bypass the slot pool entirely — they are
        # answered the tick they would have been admitted, in admission
        # order, even when every slot is busy.
        fp = [q for q in self.queue
              if metric_spec(q.req.metric).fixed_point]
        if fp:
            self.queue = [q for q in self.queue
                          if not metric_spec(q.req.metric).fixed_point]
            for q in sorted(fp, key=lambda q: q.seq):
                self._finish_fixed_point(q)
        for i in range(self.n_slots):
            if self.slots[i] is not None or not self.queue:
                continue
            q = self._pop_next()
            req = q.req
            g = self.graphs[req.graph]
            ex = self._graph_executor(req.graph)
            # The sampler's n_b sets the request's epoch schedule (τ₀)
            # and the unfused chunking; fused batches are assembled at
            # executor capacity regardless. Without fusion fall back to
            # the graph-wide capacity plan (the pre-fusion behavior) —
            # the plan on the response is whatever actually sized the run.
            pl = (self._plan_for_request(req) if self.fuse else ex.plan)
            # Capacity-sized requests use the *executor's* n_b — exactly
            # what solve() and the pre-fusion service did, which keeps the
            # lone-request classic path bit-identical; smaller requests
            # keep their own per-request size (the executors bucket it).
            nb = (ex.n_b if pl.n_b >= ex.plan.n_b
                  else min(pl.n_b, ex.n_b))
            # Per-job stream from (seed, rid): concurrent requests that
            # share the default seed must not draw identical sources —
            # correlated streams silently defeat independent (ε, δ)
            # guarantees. Same (seed, rid) still reproduces exactly.
            sampler = AdaptiveSampler(g.n, eps=req.eps, delta=req.delta,
                                      n_b=nb, cap=req.max_samples,
                                      seed=(req.seed, req.rid))
            est = LambdaEstimator(g.n, req.eps, req.delta, req.rule)
            self.slots[i] = _Job(req=req, sampler=sampler, est=est,
                                 plan=pl, t0=time.monotonic(),
                                 t_submit=q.t_submit, deadline=q.deadline,
                                 seq=q.seq)

    def _retire(self, i: int, converged: bool) -> None:
        job = self.slots[i]
        # What est.result() gives at its top k, without the whole graph's
        # halfwidths.
        ids, lam, hw = job.est.top(job.req.k)
        now = time.monotonic()
        # checkpoints=True: snapshot the (S1, S2, τ) sums + sampling
        # stream so a cached answer stays *resumable* — the gateway's
        # looser-ε cache hits refine from here instead of resampling.
        ckpt = (checkpoint_from(job.est, job.sampler, n_epochs=job.n_epochs)
                if self.checkpoints else None)
        self.finished.append(BCResponse(
            rid=job.req.rid, graph=job.req.graph, topk=ids.tolist(),
            lam=lam, halfwidth=hw, n_samples=job.est.tau,
            n_epochs=job.n_epochs, converged=converged,
            seconds=now - job.t0, plan=job.plan,
            tier=job.req.priority, latency_s=now - job.t_submit,
            digest=self.digest(job.req.graph), checkpoint=ckpt,
            sources=(np.concatenate(job.swept) if job.swept
                     else np.zeros(0, np.int32))))
        self.slots[i] = None
        tracing.count("serve.retired")

    # ------------------------------------------------------------------
    def _run_unfused(self, ex: BatchExecutor, job: _Job,
                     sources: np.ndarray) -> int:
        """The classic per-request path: chop one slot's sources into
        sampler-sized chunks, each padded to the executor's ``n_b``."""
        nb = job.sampler.n_b
        done = 0
        for lo in range(0, sources.shape[0], nb):
            chunk = sources[lo:lo + nb]
            k = int(chunk.shape[0])
            s1, s2, _ = ex.step(chunk, np.ones(k, bool),
                                metric=job.req.metric, hops=job.req.hops)
            with tracing.span("serve.fold", slots=1):
                job.est.update(s1, s2, k)
            tracing.count("serve.sources", k)
            tracing.count("serve.pad_rows", ex.n_b - k)
            done += k
        return done

    def _run_fused(self, name: str, ex: BatchExecutor,
                   demand: List[Tuple[int, np.ndarray]]) -> int:
        """Drain several slots' demand (already in the tick's scheduled
        order) through fused batches.

        Demand arrives pre-grouped by ``fuse_group`` — every slot here
        shares one sweep structure (and hop bound), so a single
        ``step_segmented`` collective serves mixed metrics: the
        executor's per-row metric tags pick each slot's contribution
        formula out of the shared (Tw, Tm) sweep.
        """
        done = 0
        for fb in self._assembler(name).assemble(demand):
            metrics = tuple(self.slots[key].req.metric for key in fb.slots)
            hops = self.slots[fb.slots[0]].req.hops
            s1, s2, nr = ex.step_segmented(fb.sources, fb.valid,
                                           fb.slot_ids, fb.n_slots,
                                           metrics=metrics, hops=hops)
            with tracing.span("serve.fold", slots=fb.n_slots):
                for slot, (r1, r2, _, cnt) in scatter(
                        fb, (s1, s2, nr)).items():
                    self.slots[slot].est.update(r1, r2, cnt)
            tracing.count("serve.sources", fb.n_valid)
            tracing.count("serve.pad_rows",
                          ex.bucket_for(fb.sources.shape[0]) - fb.n_valid)
            done += fb.n_valid
        return done

    def step(self) -> int:
        """One tick: admit, schedule, then drain demand under the budget.

        1. **admit** queued requests into free slots (EDF with aging,
           or FIFO);
        2. **refill**: every active slot with no outstanding backlog
           asks its sampler for one epoch of demand (drawn up front —
           the RNG stream is chunking-invariant, so deferral cannot
           change which sources a request samples); samplers that are
           done (stopped or capped) retire their slot honestly;
        3. **schedule**: all slots' backlogs are ordered by the ``pack``
           policy (deadline slack / fair share / FIFO) and, if
           ``tick_budget`` is set, truncated to the budget — the tail
           keeps its remaining sources as backlog for the next tick
           (mid-epoch preemption);
        4. **execute**: the scheduled demand is grouped by graph (each
           group resolves its executor once) and drained — fused into
           slot-tagged batches when more than one request is live on
           the graph — and slots whose epoch completed run the same
           sequential ``stopping_check`` as ``repro_torch.bc.solve``.

        Returns the number of source samples processed this tick.

        Under ``torch.profiler`` the tick is a ``serve.tick`` span of
        ``repro_torch.tracing`` (active, queued: the slots and queue it
        starts from); inside it each batch's estimator updates are a
        ``serve.fold`` span (slots) and each epoch-boundary test a
        ``serve.stop_check`` span (tau, eps). The counters
        ``serve.sources`` and ``serve.pad_rows`` add each batch's valid
        and padding rows, ``serve.retired`` each finished request.
        """
        with tracing.span("serve.tick", self.device, active=self.active,
                          queued=len(self.queue)):
            return self._tick()

    def _tick(self) -> int:
        self._admit()
        now = time.monotonic()
        # -- refill: one epoch of demand per idle-backlog slot ----------
        for i in range(self.n_slots):
            job = self.slots[i]
            if job is None or job.backlog.size or job.epoch_idx is not None:
                continue
            nxt = job.sampler.next_epoch()
            if nxt is None:
                # Stopped or capped: certify honestly (Hoeffding budget
                # reached, or the empirical CIs) — a cap below the
                # budget is NOT convergence by itself.
                self._retire(i, converged=honest_converged(job.est))
                continue
            ei, tau_e = nxt
            job.epoch_idx = ei
            job.backlog = job.sampler.draw(tau_e)
        # -- schedule: policy order + tick budget over ALL graphs.
        # Base order is admission order (job.seq), NOT slot index: slots
        # recycle, so under pack="fifo" with a tick budget an old
        # request in a high slot would otherwise be starved by fresh
        # admissions landing in lower slots. --
        live = sorted(((i, self.slots[i]) for i in range(self.n_slots)
                       if self.slots[i] is not None
                       and self.slots[i].backlog.size),
                      key=lambda e: e[1].seq)
        slack = {i: job.deadline - now for i, job in live}
        tenant = {i: job.req.tenant for i, job in live}
        ordered = order_demand([(i, job.backlog) for i, job in live],
                               self.pack, slack=slack, tenant=tenant,
                               served=self._served)
        remaining = (math.inf if self.tick_budget is None
                     else int(self.tick_budget))
        sched: List[Tuple[int, np.ndarray]] = []
        for i, rows in ordered:
            if remaining <= 0:
                break  # preempted: rows stay in the slot's backlog
            k = int(min(rows.size, remaining))
            sched.append((i, rows[:k]))
            self.slots[i].backlog = rows[k:]
            remaining -= k
        # -- execute per (graph, fuse group): metrics sharing one sweep
        # structure (betweenness + closeness; khop at one hop bound)
        # fuse into a single collective, mismatched structures drain as
        # separate batches (order preserved within each group) ------
        processed = 0
        by_group: Dict[Tuple[str, str], List[Tuple[int, np.ndarray]]] = {}
        for i, rows in sched:
            r = self.slots[i].req
            by_group.setdefault((r.graph, fuse_group(r.metric, r.hops)),
                                []).append((i, rows))
        for (name, _), dem in by_group.items():
            ex = self._graph_executor(name)  # once per group, not per slot
            lone = (len(dem) == 1
                    and self.slots[dem[0][0]].sampler.n_b == ex.n_b)
            if self.fuse and not lone:
                processed += self._run_fused(name, ex, dem)
            else:
                for i, srcs in dem:
                    processed += self._run_unfused(ex, self.slots[i], srcs)
            for i, rows in dem:
                job = self.slots[i]
                job.swept.append(rows)
                t = job.req.tenant
                self._served[t] = self._served.get(t, 0) + int(rows.size)
        # -- epoch boundary: same sequential test as repro_torch.bc.solve
        # (one hw pass per epoch, δ split across checks) so CLI and
        # service answers agree. Only fully drained epochs are tested —
        # a preempted slot's epoch waits for its deferred chunks. --
        for i, _ in sched:
            job = self.slots[i]
            if job is None or job.backlog.size or job.epoch_idx is None:
                continue
            ei = job.epoch_idx
            job.n_epochs = ei + 1
            job.epoch_idx = None
            with tracing.span("serve.stop_check", tau=job.est.tau,
                              eps=job.req.eps):
                done, _ = stopping_check(job.est, job.req.eps, job.req.k, ei,
                                         device=self._check_device)
            if done:
                job.sampler.stop()
                self._retire(i, converged=True)
        return processed

    @property
    def active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def pending(self) -> List[BCRequest]:
        """Requests admitted or queued but not yet finished (queued part
        in admission order)."""
        key = ((lambda q: q.seq) if self.pack == "fifo"
               else (lambda q: (q.deadline, q.seq)))
        return ([job.req for job in self.slots if job is not None]
                + [q.req for q in sorted(self.queue, key=key)])

    def run(self, max_ticks: int = 10_000) -> List[BCResponse]:
        ticks = 0
        while (self.queue or self.active) and ticks < max_ticks:
            self.step()
            ticks += 1
        # Never drop queued/active work silently: callers can see the
        # cut-off and the exact requests still outstanding.
        self.exhausted = bool(self.queue or self.active)
        return self.finished
