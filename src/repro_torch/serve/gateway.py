"""HTTP gateway + overload-aware admission in front of ``BCService``.

The serving stack so far ends at a Python object: ``BCService.submit``
then ``tick``. This module puts a wire protocol in front of it — a
stdlib-only (``http.server``) JSON API — and composes the two pieces
that make repeated centrality queries cheap at the edge:

* the **content-addressed result cache** (``serve.cache.ResultCache``):
  finished responses keyed on the canonical graph digest + (δ, k, rule,
  tier). An equal-or-tighter-ε entry answers instantly; a looser one is
  returned immediately with ``refining=true`` while the estimator
  resumes from its checkpointed (S1, S2, τ) sums toward the tighter
  target (``repro_torch.bc.resume_approx``) — cached samples are never
  thrown away.
* **overload-aware admission**: each miss is priced by its per-request
  plan (``BCPlan.predicted_seconds``, the §6.2 α-β cost model), and the
  gateway tracks the predicted backlog *at equal-or-tighter deadlines*
  — the work EDF will run before this request. When that exceeds the
  configured horizon the request is refused (HTTP 429 + retry-after)
  or, under ``overload="degrade"``, admitted at a looser ε recorded on
  the response. Deadline-relative backlog means a flood of batch-tier
  work can never talk the gateway into rejecting interactive requests:
  the tight tier only sees backlog that genuinely runs before it.

Endpoints (all JSON)::

    POST /v1/bc        {graph, eps?, delta?, k?, rule?, seed?,
                        priority?, deadline_s?, tenant?,
                        metric?, hops?}
                       -> 202 {rid, status} | 200 (cache) | 429 | 404
    GET  /v1/bc/{rid}  -> {rid, status: queued|running|partial|done,
                           queue_depth, result?, refining?, latency_s?,
                           progress?}   (progress while running: the
                           epoch-by-epoch CI-halfwidth history)
    GET  /v1/graphs    -> {graphs: [{name, n, m, digest, plan}]}
    GET  /v1/metrics   -> per-tier admit/reject/degrade/cache counters
                          + cache stats + queue depths + the learned
                          per-(metric, backend) admission correction

``metric`` picks the analytic (any ``repro_torch.bc.registered_metrics()``
name — betweenness, closeness, khop + hops, components); every metric
rides the same plan → admit → slot/fuse → cache path, and cache keys
carry the metric so distinct analytics never collide.

Threading: HTTP handler threads only touch the gateway under its lock
(submit, poll, metrics — all O(pending)); a single worker thread owns
the solver side, alternating ``BCService.step()`` ticks with queued
cache refinements, so the service object itself is never entered
concurrently. On the card that thread is the one that builds the kernels
at first use and launches them.

A copy of ``repro.serve.gateway`` over the port, with one difference of
interface: an exception that escapes a service tick on the worker (a
kernel that does not build or launch, say) is recorded and stops the
worker, and ``BCGateway.close()`` (so ``GatewayServer.close()``)
re-raises it. The reference's worker thread dies with it silently, and
every pending request stays ``queued``.
"""
from __future__ import annotations

import dataclasses
import json
import math
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Dict, List, Optional, Tuple

from repro_torch.bc import (TIER_DEADLINE_S, TIERS, ApproxCheckpoint,
                            metric_spec, resume_approx)
from repro_torch.serve.bc_service import BCRequest, BCResponse, BCService
from repro_torch.serve.cache import HIT, MISS, REFINE, ResultCache

__all__ = ["GatewayConfig", "GatewayMetrics", "BCGateway",
           "GatewayServer", "start_gateway"]


@dataclasses.dataclass(frozen=True)
class GatewayConfig:
    """Gateway policy knobs (admission, overload response, cache).

    ``horizon_s`` is the admission horizon: a request is overloaded when
    the predicted seconds of pending work at equal-or-tighter deadlines,
    plus its own prediction, exceed it. ``overload`` picks the response
    — ``"reject"`` (HTTP 429 + retry-after) or ``"degrade"`` (admit at
    ``max(eps, degrade_eps)``, recorded on the response). ``refine``
    gates the looser-ε cache path; switching it off turns those lookups
    into plain misses.
    """

    horizon_s: float = 5.0
    overload: str = "reject"  # or "degrade"
    degrade_eps: float = 0.2  # ε floor a degraded request is relaxed to
    retry_after_s: Optional[float] = None  # None: computed from backlog
    cache_entries: int = 256
    refine: bool = True
    idle_sleep_s: float = 0.001  # worker sleep when no work is pending

    def __post_init__(self) -> None:
        if self.overload not in ("reject", "degrade"):
            raise ValueError(f"overload must be 'reject' or 'degrade', "
                             f"got {self.overload!r}")
        if self.horizon_s <= 0:
            raise ValueError("horizon_s must be positive")


class GatewayMetrics:
    """Per-tier admission/cache counters behind one lock.

    Everything the overload gate and the cache do is counted per latency
    tier, so the bench harness (and ``tools/check_bench.py``) can verify
    that a loose-tier flood raises loose rejects without starving the
    interactive tier.
    """

    COUNTERS = ("submitted", "admitted", "rejected", "degraded",
                "cache_hits", "cache_refines", "completed", "refined",
                "errors")

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._c: Dict[str, Dict[str, int]] = {
            t: {c: 0 for c in self.COUNTERS} for t in TIERS}

    def bump(self, tier: str, counter: str, by: int = 1) -> None:
        with self._lock:
            self._c[tier][counter] += by

    def snapshot(self) -> Dict:
        with self._lock:
            tiers = {t: dict(c) for t, c in self._c.items()}
        totals = {c: sum(tiers[t][c] for t in tiers)
                  for c in self.COUNTERS}
        return {"tiers": tiers, "totals": totals}


@dataclasses.dataclass
class _GwRequest:
    """Registry entry: one submitted request's lifecycle."""

    rid: int
    tier: str
    eps: float  # effective ε (after any degrade)
    status: str  # queued | running | partial | done | error
    t_submit: float
    deadline_rel: float  # relative deadline used for admission
    predicted_s: float = 0.0
    # cache-key params (with eps/tier): what the finished answer is
    # cached under when the service retires it
    delta: float = 0.1
    k: int = 10
    rule: str = "normal"
    metric: str = "betweenness"
    hops: int = 0
    result: Optional[Dict] = None  # BCResponse.to_json payload
    cached: bool = False
    refining: bool = False
    refined: bool = False
    degraded_from: Optional[float] = None  # original ε if degraded
    error: Optional[str] = None
    latency_s: Optional[float] = None


@dataclasses.dataclass
class _RefineJob:
    """One queued background refinement (looser cache entry → tight ε)."""

    rid: int
    req: BCRequest
    checkpoint: ApproxCheckpoint
    digest: str
    t_submit: float


class BCGateway:
    """The gateway core: cache → admission → service, plus the registry.

    Owns a ``BCService`` (which should run with ``checkpoints=True`` —
    without checkpoints finished answers still cache, but looser entries
    can only HIT, never refine) and a ``ResultCache``. All public
    methods are thread-safe; the solver only ever runs on the worker
    thread (``start``/``close``), or inline via ``drain`` for
    single-threaded tests. An exception that escapes the worker's tick
    stops the worker and is re-raised by ``close()``.
    """

    def __init__(self, service: BCService,
                 config: Optional[GatewayConfig] = None):
        self.service = service
        self.config = config or GatewayConfig()
        self.cache = ResultCache(max_entries=self.config.cache_entries)
        self.metrics = GatewayMetrics()
        self._lock = threading.RLock()
        self._requests: Dict[int, _GwRequest] = {}
        self._refines: List[_RefineJob] = []
        self._next_rid = 0
        self._stop = threading.Event()
        self._worker: Optional[threading.Thread] = None
        self._failure: Optional[Exception] = None  # what stopped the worker
        # Admission recalibration: EWMA of observed latency_s /
        # predicted_seconds per (metric, backend), multiplied into each
        # miss's predicted cost before the horizon test. The α-β model
        # prices relative work well but its absolute scale drifts with
        # the machine; a consistently slow solver inflates the factor
        # above 1 and the horizon tightens to match reality.
        self._correction: Dict[Tuple[str, str], float] = {}

    _EWMA_ALPHA = 0.3  # smoothing for the admission correction factor

    def _observe_latency(self, metric: str, backend: str, seconds: float,
                         predicted: float) -> None:
        """Fold one finished run's observed/predicted ratio into the
        (metric, backend) admission correction EWMA. Callers hold the
        gateway lock."""
        if predicted <= 0 or seconds <= 0:
            return
        key = (metric, backend)
        ratio = seconds / predicted
        prev = self._correction.get(key)
        self._correction[key] = (
            ratio if prev is None
            else (1.0 - self._EWMA_ALPHA) * prev + self._EWMA_ALPHA * ratio)

    def _predict(self, req: BCRequest) -> float:
        """Admission price: the plan's α-β prediction scaled by the
        (metric, backend) correction learned from finished runs."""
        plan = self.service.request_plan(req)
        factor = self._correction.get((req.metric, plan.backend), 1.0)
        return float(plan.predicted_seconds) * factor

    # ------------------------------------------------------------ submit
    def submit(self, payload: Dict) -> Dict:
        """One POST /v1/bc: cache lookup → admission → service submit.

        Returns a JSON-able dict whose ``http_status`` key the HTTP
        layer peels off: 200 done-from-cache, 202 accepted (queued or
        partial-with-refinement), 429 overloaded, 400/404 bad input.
        """
        try:
            graph = payload["graph"]
        except (KeyError, TypeError):
            return {"http_status": 400, "error": "missing 'graph'"}
        if graph not in self.service.graphs:
            return {"http_status": 404,
                    "error": f"unknown graph {graph!r}",
                    "graphs": sorted(self.service.graphs)}
        tier = payload.get("priority", "normal")
        if tier not in TIERS:
            return {"http_status": 400,
                    "error": f"priority must be one of {TIERS}"}
        eps = float(payload.get("eps", 0.05))
        delta = float(payload.get("delta", 0.1))
        k = int(payload.get("k", 10))
        rule = payload.get("rule", "normal")
        seed = int(payload.get("seed", 0))
        deadline_rel = float(payload.get("deadline_s")
                             or TIER_DEADLINE_S[tier])
        tenant = payload.get("tenant", "default")
        if eps <= 0 or not (0 < delta < 1) or k <= 0:
            return {"http_status": 400,
                    "error": "need eps > 0, 0 < delta < 1, k > 0"}
        metric = payload.get("metric", "betweenness")
        hops = int(payload.get("hops", 0))
        try:
            spec = metric_spec(metric)
        except ValueError as e:
            return {"http_status": 400, "error": str(e)}
        if spec.bounded and hops < 1:
            return {"http_status": 400,
                    "error": f"metric {metric!r} needs hops >= 1"}
        if not spec.bounded and hops:
            return {"http_status": 400,
                    "error": f"hops only applies to hop-bounded metrics, "
                             f"not {metric!r}"}
        # Metric component of the cache key: distinct metrics (and
        # distinct hop bounds) must never share an entry.
        cache_metric = f"{metric}:{hops}" if spec.bounded else metric

        with self._lock:
            self.metrics.bump(tier, "submitted")
            now = time.monotonic()
            digest = self.service.digest(graph)
            entry, kind = self.cache.lookup(
                digest, eps=eps, delta=delta, k=k, rule=rule, tier=tier,
                metric=cache_metric)
            if kind == REFINE and not self.config.refine:
                entry, kind = None, MISS

            rid = self._next_rid
            self._next_rid += 1

            if kind == HIT:
                # Served verbatim from cache: the payload is the exact
                # wire form of the run that produced it (its rid names
                # that run; the top-level rid names this request).
                self.metrics.bump(tier, "cache_hits")
                self.metrics.bump(tier, "completed")
                gw = _GwRequest(rid=rid, tier=tier, eps=eps, status="done",
                                t_submit=now, deadline_rel=deadline_rel,
                                result=entry.payload, cached=True,
                                latency_s=time.monotonic() - now)
                self._requests[rid] = gw
                return {"http_status": 200, **self._status_doc(gw)}

            req = BCRequest(rid=rid, graph=graph, k=k, eps=eps,
                            delta=delta, rule=rule, seed=seed,
                            priority=tier, deadline_s=deadline_rel,
                            tenant=tenant, metric=metric, hops=hops)

            if kind == REFINE:
                # Looser entry answers now; the tighter run continues
                # from its checkpoint on the worker instead of
                # resampling from scratch.
                self.metrics.bump(tier, "cache_refines")
                gw = _GwRequest(rid=rid, tier=tier, eps=eps,
                                status="partial", t_submit=now,
                                deadline_rel=deadline_rel,
                                result=entry.payload, refining=True,
                                metric=metric, hops=hops)
                self._requests[rid] = gw
                self._refines.append(_RefineJob(
                    rid=rid, req=req, checkpoint=entry.checkpoint,
                    digest=digest, t_submit=now))
                return {"http_status": 202, **self._status_doc(gw)}

            # MISS: price the request (α-β prediction × the learned
            # (metric, backend) correction) and test the admission
            # horizon.
            pred = self._predict(req)
            backlog = self._backlog_at(deadline_rel)
            if backlog + pred > self.config.horizon_s:
                if self.config.overload == "reject":
                    self.metrics.bump(tier, "rejected")
                    retry = (self.config.retry_after_s
                             if self.config.retry_after_s is not None
                             else max(0.1,
                                      backlog + pred - self.config.horizon_s))
                    # No registry entry: a rejected request never
                    # existed as far as the solver is concerned.
                    self._next_rid = rid
                    return {"http_status": 429, "error": "overloaded",
                            "retry_after_s": round(retry, 3),
                            "backlog_s": round(backlog, 3),
                            "predicted_s": round(pred, 3),
                            "horizon_s": self.config.horizon_s}
                degraded = max(eps, self.config.degrade_eps)
                if degraded > eps:
                    self.metrics.bump(tier, "degraded")
                    req = dataclasses.replace(req, eps=degraded)
                    pred = self._predict(req)
                    gw_degraded_from: Optional[float] = eps
                    eps = degraded
                else:
                    gw_degraded_from = None
            else:
                gw_degraded_from = None

            self.metrics.bump(tier, "admitted")
            gw = _GwRequest(rid=rid, tier=tier, eps=eps, status="queued",
                            t_submit=now, deadline_rel=deadline_rel,
                            predicted_s=pred, delta=delta, k=k, rule=rule,
                            metric=metric, hops=hops,
                            degraded_from=gw_degraded_from)
            self._requests[rid] = gw
            self.service.submit(req)
            return {"http_status": 202, **self._status_doc(gw)}

    def _backlog_at(self, deadline_rel: float) -> float:
        """Predicted seconds of unfinished work EDF runs before a request
        with this relative deadline (equal-or-tighter deadlines only)."""
        return sum(gw.predicted_s for gw in self._requests.values()
                   if gw.status in ("queued", "running")
                   and gw.deadline_rel <= deadline_rel)

    # ------------------------------------------------------------- poll
    def get(self, rid: int) -> Optional[Dict]:
        """One GET /v1/bc/{rid}; None for unknown rids (HTTP 404)."""
        with self._lock:
            gw = self._requests.get(rid)
            if gw is None:
                return None
            if gw.status == "queued" and any(
                    job is not None and job.req.rid == rid
                    for job in self.service.slots):
                gw.status = "running"
            return self._status_doc(gw)

    def _status_doc(self, gw: _GwRequest) -> Dict:
        doc: Dict = {"rid": gw.rid, "status": gw.status, "tier": gw.tier,
                     "eps": gw.eps, "queue_depth": self._queue_depth()}
        if gw.degraded_from is not None:
            doc["degraded_from"] = gw.degraded_from
        if gw.status in ("queued", "running"):
            doc["predicted_s"] = round(gw.predicted_s, 4)
        if gw.status == "running":
            # Streaming partial results: the estimator's epoch-by-epoch
            # (τ, max normalized halfwidth) history, so pollers watch a
            # long run converge instead of a frozen "running". Early
            # epochs can have an undefined (infinite) halfwidth — JSON
            # has no inf, so those stream as null.
            hist = self.service.progress(gw.rid)
            if hist:
                doc["progress"] = {"epochs": [
                    {"tau": int(t),
                     "halfwidth": (float(h) if math.isfinite(h) else None)}
                    for t, h in hist]}
        if gw.refining:
            doc["refining"] = True
        if gw.result is not None:
            doc["result"] = gw.result
            doc["cached"] = gw.cached
            doc["refined"] = gw.refined
        if gw.latency_s is not None:
            doc["latency_s"] = gw.latency_s
        if gw.error is not None:
            doc["error"] = gw.error
        return doc

    def _queue_depth(self) -> Dict[str, int]:
        depth = {t: 0 for t in TIERS}
        for gw in self._requests.values():
            if gw.status in ("queued", "running", "partial"):
                depth[gw.tier] += 1
        return depth

    # ---------------------------------------------------------- listing
    def graphs(self) -> Dict:
        with self._lock:
            return {"graphs": [self.service.describe_graph(name)
                               for name in sorted(self.service.graphs)]}

    def metrics_doc(self) -> Dict:
        doc = self.metrics.snapshot()
        doc["cache"] = self.cache.stats()
        with self._lock:
            doc["queue_depth"] = self._queue_depth()
            doc["admission_correction"] = {
                f"{m}/{b}": round(v, 4)
                for (m, b), v in sorted(self._correction.items())}
        return doc

    # ------------------------------------------------------ solver side
    def drain(self, max_ticks: int = 10_000) -> None:
        """Run the solver inline until nothing is pending (test hook —
        the HTTP path uses the worker thread instead)."""
        for _ in range(max_ticks):
            if not self._work_once():
                return

    def _work_once(self) -> bool:
        """One worker beat: a service tick or one refinement. True if
        any work happened (False = idle, the worker may sleep)."""
        with self._lock:
            if self.service.queue or self.service.active:
                self.service.step()
                self._drain_finished()
                return True
            if self._refines:
                job = self._refines.pop(0)
                self._run_refine(job)
                return True
        return False

    def _drain_finished(self) -> None:
        for resp in self.service.finished:
            gw = self._requests.get(resp.rid)
            if gw is None or gw.status == "done":
                continue
            payload = resp.to_json()
            gw.result = payload
            gw.status = "done"
            gw.latency_s = time.monotonic() - gw.t_submit
            self.metrics.bump(gw.tier, "completed")
            if resp.plan is not None:
                self._observe_latency(gw.metric, resp.plan.backend,
                                      float(resp.seconds),
                                      float(resp.plan.predicted_seconds))
            # Fixed-point answers (components) are exact: cache them at
            # ε = 0 so every future ε for the key HITs outright.
            put_eps = (0.0 if metric_spec(gw.metric).fixed_point
                       else gw.eps)
            self.cache.put(resp.digest, eps=put_eps, delta=gw.delta,
                           k=gw.k, rule=gw.rule, tier=gw.tier,
                           metric=self._cache_metric(gw),
                           payload=payload, checkpoint=resp.checkpoint)
        self.service.finished.clear()

    @staticmethod
    def _cache_metric(gw: _GwRequest) -> str:
        """The metric component of a registry entry's cache key (hop
        bounds fold in — ``hops`` is nonzero iff the metric is
        bounded)."""
        return f"{gw.metric}:{gw.hops}" if gw.hops else gw.metric

    def _run_refine(self, job: _RefineJob) -> None:
        t0 = time.monotonic()
        gw = self._requests[job.rid]
        try:
            ex = self.service.executor_for(job.req.graph)
            res, ckpt = resume_approx(
                ex, job.checkpoint, eps=job.req.eps, delta=job.req.delta,
                topk=job.req.k, max_samples=job.req.max_samples,
                metric=job.req.metric, hops=job.req.hops)
            ids = res.topk(job.req.k)
            now = time.monotonic()
            resp = BCResponse(
                rid=job.rid, graph=job.req.graph, topk=ids.tolist(),
                lam=res.lam[ids], halfwidth=res.halfwidth[ids],
                n_samples=res.n_samples, n_epochs=res.n_epochs,
                converged=res.converged, seconds=now - t0,
                plan=self.service.request_plan(job.req),
                tier=job.req.priority, latency_s=now - job.t_submit,
                digest=job.digest, checkpoint=ckpt)
            payload = resp.to_json()
            self.cache.put(job.digest, eps=job.req.eps,
                           delta=job.req.delta, k=job.req.k,
                           rule=job.req.rule, tier=job.req.priority,
                           metric=(f"{job.req.metric}:{job.req.hops}"
                                   if job.req.hops else job.req.metric),
                           payload=payload, checkpoint=ckpt)
            gw.result = payload
            gw.status = "done"
            gw.refining = False
            gw.refined = True
            gw.latency_s = now - job.t_submit
            self.metrics.bump(gw.tier, "refined")
            self.metrics.bump(gw.tier, "completed")
        except Exception as e:  # surface, never kill the worker
            gw.status = "error"
            gw.refining = False
            gw.error = f"{type(e).__name__}: {e}"
            self.metrics.bump(gw.tier, "errors")

    # ----------------------------------------------------------- worker
    def start(self) -> None:
        if self._worker is not None:
            return
        self._stop.clear()
        self._worker = threading.Thread(target=self._loop,
                                        name="bc-gateway-worker",
                                        daemon=True)
        self._worker.start()

    def _loop(self) -> None:
        try:
            while not self._stop.is_set():
                if not self._work_once():
                    time.sleep(self.config.idle_sleep_s)
        except Exception as e:  # the worker's boundary: kept for close()
            self._failure = e

    def close(self) -> None:
        """Stop the worker; re-raise the exception that stopped it, if
        one did."""
        self._stop.set()
        if self._worker is not None:
            self._worker.join(timeout=5.0)
            self._worker = None
        failure, self._failure = self._failure, None
        if failure is not None:
            raise failure


# ---------------------------------------------------------------- HTTP
class _Handler(BaseHTTPRequestHandler):
    """Thin JSON shim: routes to the gateway, never touches the solver."""

    server: "GatewayHTTPServer"

    def log_message(self, fmt: str, *args) -> None:  # silence stderr
        pass

    def _reply(self, status: int, doc: Dict,
               headers: Optional[Dict[str, str]] = None) -> None:
        body = json.dumps(doc).encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(body)))
        for k, v in (headers or {}).items():
            self.send_header(k, v)
        self.end_headers()
        self.wfile.write(body)

    def do_POST(self) -> None:
        if self.path.rstrip("/") != "/v1/bc":
            self._reply(404, {"error": f"no route {self.path}"})
            return
        try:
            length = int(self.headers.get("Content-Length", 0))
            payload = json.loads(self.rfile.read(length) or b"{}")
        except (ValueError, json.JSONDecodeError):
            self._reply(400, {"error": "body must be JSON"})
            return
        doc = self.server.gateway.submit(payload)
        status = doc.pop("http_status")
        headers = ({"Retry-After": str(doc["retry_after_s"])}
                   if status == 429 else None)
        self._reply(status, doc, headers)

    def do_GET(self) -> None:
        gw = self.server.gateway
        path = self.path.rstrip("/")
        if path == "/v1/graphs":
            self._reply(200, gw.graphs())
        elif path == "/v1/metrics":
            self._reply(200, gw.metrics_doc())
        elif path.startswith("/v1/bc/"):
            try:
                rid = int(path.rsplit("/", 1)[1])
            except ValueError:
                self._reply(400, {"error": "rid must be an integer"})
                return
            doc = gw.get(rid)
            if doc is None:
                self._reply(404, {"error": f"unknown rid {rid}"})
            else:
                self._reply(200, doc)
        else:
            self._reply(404, {"error": f"no route {self.path}"})


class GatewayHTTPServer(ThreadingHTTPServer):
    daemon_threads = True

    def __init__(self, addr, gateway: BCGateway):
        super().__init__(addr, _Handler)
        self.gateway = gateway


@dataclasses.dataclass
class GatewayServer:
    """A running gateway: HTTP server + worker thread, one ``close()``."""

    gateway: BCGateway
    httpd: GatewayHTTPServer
    thread: threading.Thread

    @property
    def port(self) -> int:
        return self.httpd.server_address[1]

    @property
    def url(self) -> str:
        host, port = self.httpd.server_address[:2]
        return f"http://{host}:{port}"

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self.thread.join(timeout=5.0)
        self.gateway.close()


def start_gateway(gateway: BCGateway, host: str = "127.0.0.1",
                  port: int = 0) -> GatewayServer:
    """Serve a gateway on (host, port); port 0 picks an ephemeral port.

    Starts both the HTTP listener and the gateway's solver worker;
    ``GatewayServer.close()`` tears both down.
    """
    httpd = GatewayHTTPServer((host, port), gateway)
    thread = threading.Thread(target=httpd.serve_forever,
                              name="bc-gateway-http", daemon=True)
    thread.start()
    gateway.start()
    return GatewayServer(gateway=gateway, httpd=httpd, thread=thread)
