"""The port's HTTP gateway (``repro_torch.serve.gateway``) against the
reference's, and its launcher.

* Parity: one POST sequence — misses, a cache hit, a looser hit, a
  refine, every metric, bad input — through ``repro.serve.BCGateway`` and
  the port's, each drained inline. The status documents are equal once
  the timing fields are masked; λ̂ and the halfwidths in them agree within
  rtol 1e-5; the metrics documents have the same counters.
* Mirrors of ``tests/test_gateway.py``, a real server on an ephemeral
  port, held to the same assertions. The overload mirror builds the HTTP
  listener without starting the solver's worker, so the burst's admission
  decisions never race the worker: the batch flood is the first 202 and
  then only 429s, the interactive request is admitted, and every admitted
  request is done once the worker starts.
* The worker re-raise: an executor that raises stops the worker, and
  ``GatewayServer.close()`` re-raises it (the reference's worker dies
  silently and its requests stay ``queued``).
* ``python -m repro_torch.launch.bc_serve``: ``--device cpu`` serves and
  exits under ``--run-for``; the default exits naming ``--device cpu`` on
  a host without a card.
"""
import copy
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import repro.serve as jserve
import repro_torch.serve as tserve
from repro.graphs.generators import rmat as jrmat
from repro_torch.graphs import Graph
from repro_torch.graphs.generators import rmat
from repro_torch.launch import bc_serve
from repro_torch.serve import BCGateway, BCService, GatewayConfig, start_gateway
from repro_torch.serve.bc_service import BCRequest
from repro_torch.serve.gateway import GatewayHTTPServer, GatewayServer

_CACHE = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these graphs are tiny, and the suite runs
    several workers at once, whose thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph():
    if "g" not in _CACHE:
        g = rmat(6, 8, seed=5)
        g, _ = g.remove_isolated()
        _CACHE["g"] = g
    return _CACHE["g"]


def _service(**kw) -> BCService:
    return BCService({"web": _graph()}, checkpoints=True, device="cpu", **kw)


def _server(**cfg):
    return start_gateway(BCGateway(_service(), GatewayConfig(**cfg)))


def _post(base, doc):
    req = urllib.request.Request(f"{base}/v1/bc",
                                 data=json.dumps(doc).encode(),
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read()), dict(r.headers)
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read()), dict(e.headers)


def _get(base, path):
    try:
        with urllib.request.urlopen(f"{base}{path}") as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


def _poll_done(base, rid, timeout_s=30.0):
    t0 = time.monotonic()
    while time.monotonic() - t0 < timeout_s:
        st, doc = _get(base, f"/v1/bc/{rid}")
        assert st == 200
        if doc["status"] in ("done", "error"):
            return doc
        time.sleep(0.005)
    raise AssertionError(f"rid {rid} not done within {timeout_s}s")


# ------------------------------------------------------------------ parity
_TIMING = ("latency_s", "seconds", "predicted_s")
_SEQUENCE = (
    {"graph": "web", "eps": 0.15, "k": 10},
    {"graph": "web", "eps": 0.15, "k": 10},  # HIT
    {"graph": "web", "eps": 0.3, "k": 10},  # looser: HIT
    {"graph": "web", "eps": 0.05, "k": 10},  # tighter: REFINE
    {"graph": "web", "eps": 0.1, "seed": 3, "metric": "closeness",
     "priority": "interactive"},
    {"graph": "web", "eps": 0.1, "seed": 3, "metric": "khop", "hops": 2,
     "priority": "batch", "tenant": "b"},
    {"graph": "web", "metric": "components"},
    {"graph": "web", "metric": "components", "eps": 0.001},  # exact: HIT
    {"graph": "web", "eps": 0.2, "rule": "bernstein", "deadline_s": 2.0},
    {"graph": "nope"}, {}, {"graph": "web", "priority": "urgent"},
    {"graph": "web", "eps": -1}, {"graph": "web", "metric": "khop"},
)


def _masked(doc):
    """(doc without timing fields or λ̂/halfwidth, [(λ̂, halfwidth)])."""
    doc = copy.deepcopy(doc)
    floats = []
    for d in (doc, doc.get("result") or {}):
        for k in _TIMING:
            d.pop(k, None)
    res = doc.get("result")
    if res is not None:
        floats.append((res.pop("lam"), res.pop("halfwidth")))
    return doc, floats


def _drive(mod, g):
    gw = mod.BCGateway(mod.BCService({"web": g}, checkpoints=True,
                                     **({} if mod is jserve
                                        else {"device": "cpu"})),
                       mod.GatewayConfig(horizon_s=1e6))
    docs = []
    for payload in _SEQUENCE:
        docs.append(gw.submit(payload))
        gw.drain()
    docs += [gw.get(rid) for rid in range(gw._next_rid)]
    docs.append(gw.graphs())
    return docs, gw.metrics_doc()


def test_gateway_matches_reference():
    jg = jrmat(6, 8, seed=5).remove_isolated()[0]
    want, want_m = _drive(jserve, jg)
    got, got_m = _drive(tserve, Graph(jg.n, jg.src, jg.dst, jg.w,
                                      jg.directed, jg.name))
    assert len(got) == len(want)
    for a, b in zip(got, want):
        (da, fa), (db, fb) = _masked(a), _masked(b)
        assert da == db
        for (la, ha), (lb, hb) in zip(fa, fb):
            np.testing.assert_allclose(la, lb, rtol=1e-5)
            np.testing.assert_allclose(ha, hb, rtol=1e-5)
    assert got[3]["status"] == "partial" and got[3]["refining"]
    polls = got[len(_SEQUENCE):-1]
    assert [d["status"] for d in polls] == ["done"] * len(polls)
    assert polls[3]["refined"] and polls[1]["cached"]
    for k in ("tiers", "totals", "cache", "queue_depth"):
        assert got_m[k] == want_m[k], k
    assert set(got_m["admission_correction"]) == \
        set(want_m["admission_correction"])


# --------------------------------------------------------------- lifecycle
def test_submit_poll_done_and_cached_repeat():
    srv = _server(horizon_s=30.0)
    try:
        base = srv.url
        st, doc, _ = _post(base, {"graph": "web", "eps": 0.15, "k": 10})
        assert st == 202 and doc["status"] == "queued"
        assert set(doc["queue_depth"]) == {"interactive", "normal", "batch"}
        rid = doc["rid"]

        done = _poll_done(base, rid)
        assert done["status"] == "done" and not done["cached"]
        res = done["result"]
        assert res["graph"] == "web" and len(res["topk"]) == 10
        assert res["converged"] and res["digest"]
        assert res["plan"]["n_b"] > 0
        assert done["latency_s"] > 0

        st2, doc2, _ = _post(base, {"graph": "web", "eps": 0.15, "k": 10})
        assert st2 == 200 and doc2["status"] == "done" and doc2["cached"]
        assert doc2["result"] == res
        assert doc2["rid"] != rid

        st3, doc3, _ = _post(base, {"graph": "web", "eps": 0.3, "k": 10})
        assert st3 == 200 and doc3["cached"]
        assert doc3["result"] == res
    finally:
        srv.close()


def test_refine_serves_stale_then_bitwise_tight():
    srv = _server(horizon_s=30.0)
    try:
        base = srv.url
        st, doc, _ = _post(base, {"graph": "web", "eps": 0.15, "k": 10})
        loose = _poll_done(base, doc["rid"])["result"]

        st, doc, _ = _post(base, {"graph": "web", "eps": 0.05, "k": 10})
        assert st == 202 and doc["status"] == "partial" and doc["refining"]
        assert doc["result"] == loose
        refined = _poll_done(base, doc["rid"])
        assert refined["refined"] and not refined.get("refining")
        ref = refined["result"]
        assert ref["n_samples"] >= loose["n_samples"]
    finally:
        srv.close()

    srv2 = _server(horizon_s=30.0)
    try:
        st, doc, _ = _post(srv2.url, {"graph": "web", "eps": 0.05, "k": 10})
        scratch = _poll_done(srv2.url, doc["rid"])["result"]
        for field in ("topk", "lam", "halfwidth", "n_samples", "n_epochs",
                      "converged", "digest"):
            assert ref[field] == scratch[field], field
    finally:
        srv2.close()


# ---------------------------------------------------------------- overload
def _listener(gw: BCGateway) -> GatewayServer:
    """The HTTP front alone: the solver's worker is not started."""
    httpd = GatewayHTTPServer(("127.0.0.1", 0), gw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return GatewayServer(gateway=gw, httpd=httpd, thread=thread)


def test_overload_burst_rejects_without_starving_tight_tier():
    """A loose-tier flood past the horizon draws 429 + Retry-After while
    an interactive request still admits: admission prices only backlog at
    equal-or-tighter deadlines. The worker starts after the burst, so no
    admission decision depends on how far it got."""
    svc = _service()
    pred = float(svc.request_plan(
        BCRequest(rid=0, graph="web", eps=0.2)).predicted_seconds)
    gw = BCGateway(svc, GatewayConfig(horizon_s=pred * 1.5,
                                      idle_sleep_s=0.05))
    srv = _listener(gw)
    try:
        base = srv.url
        codes, admitted = [], []
        for _ in range(12):
            st, doc, headers = _post(base, {"graph": "web", "eps": 0.2,
                                            "priority": "batch"})
            codes.append(st)
            if st == 429:
                assert "Retry-After" in headers
                assert doc["retry_after_s"] > 0
                assert doc["backlog_s"] >= 0 and doc["horizon_s"] > 0
            else:
                admitted.append(doc["rid"])
        # one predicted solve fits the horizon, a second does not
        assert codes == [202] + [429] * 11, codes

        st, doc, _ = _post(base, {"graph": "web", "eps": 0.2,
                                  "priority": "interactive"})
        assert st == 202, doc
        admitted.append(doc["rid"])
        m = _get(base, "/v1/metrics")[1]
        assert m["tiers"]["batch"]["rejected"] == 11
        assert m["tiers"]["interactive"]["rejected"] == 0
        assert m["tiers"]["interactive"]["admitted"] == 1

        gw.start()  # now drain: every admitted request completes
        for rid in admitted:
            assert _poll_done(base, rid)["status"] == "done"
        m = _get(base, "/v1/metrics")[1]
        assert m["totals"]["errors"] == 0
        assert m["totals"]["completed"] == len(admitted)
    finally:
        srv.close()


def test_overload_degrade_records_looser_eps():
    svc = _service()
    pred = float(svc.request_plan(
        BCRequest(rid=0, graph="web", eps=0.05)).predicted_seconds)
    gw = BCGateway(svc, GatewayConfig(horizon_s=pred * 0.5,
                                      overload="degrade", degrade_eps=0.3,
                                      idle_sleep_s=0.05))
    srv = start_gateway(gw)
    try:
        base = srv.url
        st, doc, _ = _post(base, {"graph": "web", "eps": 0.05})
        assert st == 202 and doc["degraded_from"] == 0.05
        assert doc["eps"] == 0.3
        done = _poll_done(base, doc["rid"])
        assert done["degraded_from"] == 0.05
        m = _get(base, "/v1/metrics")[1]
        assert m["totals"]["degraded"] == 1 and m["totals"]["rejected"] == 0
    finally:
        srv.close()


# --------------------------------------------------------------- listings
def test_graphs_and_metrics_endpoints():
    srv = _server(horizon_s=30.0)
    try:
        base = srv.url
        st, doc = _get(base, "/v1/graphs")
        assert st == 200 and [g["name"] for g in doc["graphs"]] == ["web"]
        g = doc["graphs"][0]
        assert g["n"] > 0 and g["m"] > 0
        assert isinstance(g["digest"], str) and len(g["digest"]) == 64
        assert g["plan"]["n_b"] > 0

        st, m = _get(base, "/v1/metrics")
        assert st == 200
        assert set(m) == {"tiers", "totals", "cache", "queue_depth",
                          "admission_correction"}
        assert m["cache"]["entries"] == 0
        assert m["admission_correction"] == {}
        assert set(m["queue_depth"]) == {"interactive", "normal", "batch"}
    finally:
        srv.close()


# ----------------------------------------------------- metric-generic wire
def test_metrics_through_the_wire_and_cache_isolation():
    srv = _server(horizon_s=100.0)
    try:
        base = srv.url
        docs = {}
        for payload in ({"graph": "web", "eps": 0.1, "seed": 3},
                        {"graph": "web", "eps": 0.1, "seed": 3,
                         "metric": "closeness"},
                        {"graph": "web", "eps": 0.1, "seed": 3,
                         "metric": "khop", "hops": 2},
                        {"graph": "web", "metric": "components"}):
            st, doc, _ = _post(base, payload)
            assert st == 202, doc
            key = (payload.get("metric", "betweenness"),
                   payload.get("hops", 0))
            docs[key] = _poll_done(base, doc["rid"])
        results = {k: d["result"] for k, d in docs.items()}
        lams = [tuple(r["lam"]) for r in results.values()]
        assert len(set(lams)) == len(lams)

        for payload, key in ((
                {"graph": "web", "eps": 0.1, "seed": 3},
                ("betweenness", 0)), (
                {"graph": "web", "eps": 0.1, "seed": 3,
                 "metric": "closeness"}, ("closeness", 0))):
            st, doc, _ = _post(base, payload)
            assert st == 200 and doc["cached"]
            assert doc["result"] == results[key]

        st, doc, _ = _post(base, {"graph": "web", "metric": "components",
                                  "eps": 0.001})
        assert st == 200 and doc["cached"]
        assert doc["result"] == results[("components", 0)]

        st, doc, _ = _post(base, {"graph": "web", "eps": 0.1, "seed": 3,
                                  "metric": "khop", "hops": 3})
        assert st == 202, doc
        assert _poll_done(base, doc["rid"])["result"] != \
            results[("khop", 2)]

        assert _post(base, {"graph": "web", "metric": "nope"})[0] == 400
        assert _post(base, {"graph": "web", "metric": "khop"})[0] == 400
        assert _post(base, {"graph": "web", "hops": 2})[0] == 400
    finally:
        srv.close()


def test_slow_solver_tightens_admission():
    svc = _service()
    plan = svc.request_plan(BCRequest(rid=0, graph="web", eps=0.2))
    pred, backend = float(plan.predicted_seconds), plan.backend
    gw = BCGateway(svc, GatewayConfig(horizon_s=pred * 10))
    doc = gw.submit({"graph": "web", "eps": 0.2})
    assert doc["http_status"] == 202

    gw._observe_latency("betweenness", backend, seconds=pred * 100,
                        predicted=pred)
    doc = gw.submit({"graph": "web", "eps": 0.21})
    assert doc["http_status"] == 429, doc
    m = gw.metrics_doc()
    assert m["admission_correction"][f"betweenness/{backend}"] \
        == pytest.approx(100.0)
    doc = gw.submit({"graph": "web", "eps": 0.2, "metric": "closeness"})
    assert doc["http_status"] == 202, doc


def test_poll_streams_progress_history():
    svc = BCService({"web": _graph()}, n_slots=1, device="cpu")
    gw = BCGateway(svc, GatewayConfig(horizon_s=1000.0))
    doc = gw.submit({"graph": "web", "eps": 0.004, "delta": 0.1})
    assert doc["http_status"] == 202
    rid = doc["rid"]
    seen = None
    for _ in range(200):
        if not gw._work_once():
            break
        st = gw.get(rid)
        if st["status"] == "running" and "progress" in st:
            seen = st["progress"]
            json.dumps(st)
            assert set(seen) == {"epochs"}
            taus = [e["tau"] for e in seen["epochs"]]
            assert taus == sorted(taus) and all(
                isinstance(t, int) for t in taus)
            for e in seen["epochs"]:
                assert set(e) == {"tau", "halfwidth"}
                assert e["halfwidth"] is None or (
                    isinstance(e["halfwidth"], float)
                    and e["halfwidth"] >= 0.0)
    assert seen is not None, "no running poll carried progress"
    gw.drain()
    assert gw.get(rid)["status"] == "done"
    assert "progress" not in gw.get(rid)


def test_error_paths():
    srv = _server(horizon_s=30.0)
    try:
        base = srv.url
        assert _post(base, {"graph": "nope"})[0] == 404
        assert _post(base, {})[0] == 400
        assert _post(base, {"graph": "web", "priority": "urgent"})[0] == 400
        assert _post(base, {"graph": "web", "eps": -1})[0] == 400
        assert _get(base, "/v1/bc/999")[0] == 404
        assert _get(base, "/v1/bc/notanint")[0] == 400
        assert _get(base, "/v1/nope")[0] == 404
        req = urllib.request.Request(f"{base}/v1/bc", data=b"{not json")
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(req)
        assert ei.value.code == 400
    finally:
        srv.close()


# ------------------------------------------------------- worker re-raise
def test_worker_failure_is_reraised_on_close():
    """A kernel that fails on the worker (here: an executor whose step
    raises) stops the worker; the request stays queued, as in the
    reference, but ``close()`` re-raises the failure instead of hiding
    it."""
    svc = _service()
    ex = svc.executor_for("web")

    def broken(*args, **kwargs):
        raise RuntimeError("kernel launch failed")

    ex.step = ex.step_segmented = broken
    srv = start_gateway(BCGateway(svc, GatewayConfig(horizon_s=30.0)))
    worker = srv.gateway._worker
    st, doc, _ = _post(srv.url, {"graph": "web", "eps": 0.2})
    assert st == 202
    worker.join(timeout=30.0)
    assert not worker.is_alive()
    assert _get(srv.url, f"/v1/bc/{doc['rid']}")[1]["status"] in (
        "queued", "running")
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        srv.close()
    srv.gateway.close()  # reported once: a second close is clean


# -------------------------------------------------------------- launcher
def test_bc_serve_runs_on_cpu(capsys):
    bc_serve.main(["--device", "cpu", "--graph", "rmat:6:8", "--port", "0",
                   "--run-for", "0.2"])
    out = capsys.readouterr().out
    assert "executors built and warmed on cpu in" in out
    assert "bc gateway listening on http://127.0.0.1:" in out
    assert out.rstrip().endswith("gateway closed")


def test_bc_serve_without_a_card_names_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        bc_serve.main(["--port", "0", "--run-for", "0"])
