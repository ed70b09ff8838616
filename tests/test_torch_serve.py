"""The port's serving loop (``repro_torch.serve.BCService``) against the
reference's ``repro.serve.BCService``.

* Parity: one list of requests — mixed tiers, metrics and graphs, every
  ``pack`` policy, with and without a ``tick_budget`` — goes through both
  services on the CPU. Per rid: the retirement order, top-k, n_samples,
  n_epochs, converged, plan JSON and digest are equal; λ̂ and the
  halfwidths agree within rtol 1e-5, as the solve parity of slice 2.
* Mirrors of the reference's service tests, held to the same assertions:
  ``tests/test_qos.py``, the service tests of ``tests/test_metrics.py``,
  ``tests/test_fusion.py``, ``tests/test_approx_bc.py`` and
  ``tests/test_bc_api.py``. Where the reference compares fused
  betweenness with the same request alone within rtol 1e-5, the port
  compares it bitwise: its ``step`` and ``step_segmented`` add a batch's
  rows in the same order.
* The interface differences: a 1 × 1 mesh service (one gloo rank) is
  bitwise the single-host dense service, there is no ``backend=`` keyword,
  and the default device is the card.
"""
import json

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.serve.bc_service as jsvc
from repro.graphs.generators import rmat as jrmat
from repro.graphs.generators import ring_of_cliques as jring
from repro_torch.approx.sampling import hoeffding_budget
from repro_torch.bc import (BCQuery, ExecutionConfig, LambdaEstimator,
                            honest_converged, solve)
from repro_torch.core.brandes_ref import brandes_bc, cc_ref
from repro_torch.graphs import Graph
from repro_torch.graphs.generators import ring_of_cliques, rmat, star_graph
from repro_torch.launch.mesh import Mesh
import repro_torch.serve.bc_service as tsvc
from repro_torch.serve.bc_service import BCRequest, BCService

_CACHE = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these graphs are tiny, and the suite runs
    several workers at once, whose thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(scale=6):
    key = ("g", scale)
    if key not in _CACHE:
        g = rmat(scale, 8, seed=5)
        g, _ = g.remove_isolated()
        _CACHE[key] = g
    return _CACHE[key]


def _svc(graphs, **kw) -> BCService:
    return BCService(graphs, device="cpu", **kw)


# -------------------------------------------------------------- parity
def _mixed(mod):
    R = mod.BCRequest
    return [R(rid=0, graph="web", eps=0.1, priority="batch", seed=1),
            R(rid=1, graph="web", eps=0.15, priority="interactive",
              metric="closeness"),
            R(rid=2, graph="web", eps=0.1, metric="khop", hops=2),
            R(rid=3, graph="web", metric="components"),
            R(rid=4, graph="web", eps=0.2, tenant="b", rule="bernstein"),
            R(rid=5, graph="ring", eps=0.1, k=5, max_samples=40)]


@pytest.mark.parametrize("budget", [None, 16])
@pytest.mark.parametrize("pack", ["deadline", "fair", "fifo"])
def test_service_matches_reference(pack, budget):
    jg = jrmat(6, 8, seed=5).remove_isolated()[0]
    g = Graph(jg.n, jg.src, jg.dst, jg.w, jg.directed, jg.name)
    assert np.array_equal(g.src, _graph().src)  # one graph, both packages
    kw = dict(n_slots=3, pack=pack, tick_budget=budget, checkpoints=True)
    ref = jsvc.BCService({"web": jg, "ring": jring(5, 5)}, **kw)
    ours = _svc({"web": g, "ring": ring_of_cliques(5, 5)}, **kw)
    for r in _mixed(jsvc):
        ref.submit(r)
    for r in _mixed(tsvc):
        ours.submit(r)
    want, got = ref.run(), ours.run()
    assert not ours.exhausted
    assert [r.rid for r in got] == [r.rid for r in want]  # retirement order
    for a, b in zip(got, want):
        assert a.topk == b.topk, a.rid
        assert (a.n_samples, a.n_epochs, a.converged, a.digest, a.tier) == \
            (b.n_samples, b.n_epochs, b.converged, b.digest, b.tier)
        assert json.dumps(a.plan.to_json(), sort_keys=True) == \
            json.dumps(b.plan.to_json(), sort_keys=True)
        np.testing.assert_allclose(a.lam, b.lam, rtol=1e-5)
        np.testing.assert_allclose(a.halfwidth, b.halfwidth, rtol=1e-5)
        assert (a.checkpoint is None) == (b.checkpoint is None)
        if a.checkpoint is not None:
            assert (a.checkpoint.tau, a.checkpoint.n_epochs,
                    a.checkpoint.prefix_exact) == (
                b.checkpoint.tau, b.checkpoint.n_epochs,
                b.checkpoint.prefix_exact)


# ----------------------------------------------------- interface differences
def test_mesh_names_its_slice():
    """A 1 × 1 mesh service answers: a lone request and a fused pair on a
    one-rank gloo world, bitwise the single-host dense service's (the
    multi-rank mesh is ``tests/test_torch_mesh_serve.py``)."""
    reqs = [BCRequest(rid=0, graph="web", eps=0.1),
            BCRequest(rid=1, graph="web", eps=0.1, priority="interactive"),
            BCRequest(rid=2, graph="web", eps=0.2, seed=4)]
    host = _svc({"web": _graph()}, n_slots=2,
                execution=ExecutionConfig(backend="dense"))
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = Mesh((1, 1), ("data", "model"), device="cpu")
        svc = BCService({"web": _graph()}, n_slots=2, mesh=mesh)
        try:
            with pytest.raises(ValueError, match="the mesh's device"):
                BCService({"web": _graph()}, mesh=mesh, device="cuda:1")
            answers = []
            for batch in (reqs[:1], reqs[1:]):  # alone, then fused
                for r in batch:
                    svc.submit(r)
                    host.submit(r)
                answers.append((svc.run(), host.run()))
        finally:
            svc.close()
        assert svc.mirrored > 0 and svc.device == torch.device("cpu")
    finally:
        dist.destroy_process_group()
    got, want = answers[-1]
    assert [r.rid for r in got] == [r.rid for r in want] == [0, 1, 2]
    for a, b in zip(got, want):
        assert a.plan.placement == "mesh" and b.plan.placement == \
            "single_host"
        a, b = a.to_json(), b.to_json()
        for key in ("topk", "lam", "halfwidth", "n_samples", "n_epochs",
                    "converged"):
            assert a[key] == b[key], key


def test_service_without_a_mesh_stays_on_its_device(monkeypatch):
    """On a host with several cards a service without ``mesh=`` plans one
    device: a mesh of ranks is the caller's to build (the planner alone
    would place the graph on a mesh, whose executor needs a process
    group)."""
    import repro_torch.bc.planner as planner

    monkeypatch.setattr(planner, "device_count", lambda device: 4)
    svc = _svc({"web": _graph()})
    assert svc.plan_for("web").placement == "single_host"
    assert svc.request_plan(BCRequest(rid=0, graph="web")).n_devices == 1
    svc.submit(BCRequest(rid=0, graph="web", eps=0.2))
    assert svc.run()[0].converged


def test_no_deprecated_backend_keyword():
    with pytest.raises(TypeError, match="backend"):
        _svc({"web": _graph()}, backend="dense")


def test_service_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        BCService({"web": _graph()})


def test_fused_betweenness_bitwise_equals_alone():
    """Betweenness and closeness fused into shared ticks retire with the
    answers each gives alone, bitwise — and the lone betweenness request
    is bitwise ``solve`` over the same stream on the service's executor."""
    g = rmat(7, 16, seed=0, weighted=True, max_weight=100).remove_isolated()[0]
    reqs = [BCRequest(rid=0, graph="g", eps=0.1, priority="interactive"),
            BCRequest(rid=1, graph="g", eps=0.1, metric="closeness")]

    def serve(rs):
        svc = _svc({"g": g}, checkpoints=True)
        for r in rs:
            svc.submit(r)
        return {r.rid: r for r in svc.run()}, svc

    both, _ = serve(reqs)
    lone = {}
    for r in reqs:
        alone, svc = serve([r])
        a, b = lone[r.rid], both[r.rid] = alone[r.rid], both[r.rid]
        assert a.topk == b.topk and a.n_samples == b.n_samples
        np.testing.assert_array_equal(a.lam, b.lam)
        np.testing.assert_array_equal(a.halfwidth, b.halfwidth)
    # the service draws request rid's sources from the stream (seed, rid);
    # a request of the executor's n_b runs the classic path, as solve does
    ex = svc.executor_for("g")
    assert svc.request_plan(reqs[0]).n_b == ex.n_b
    res = solve(g, BCQuery(mode="approx", eps=0.1, delta=0.1, topk=10,
                           rule="normal", seed=(0, 0)), executor=ex,
                device="cpu")
    ids = res.topk(10)
    assert ids.tolist() == lone[0].topk
    np.testing.assert_array_equal(res.lam[ids], lone[0].lam)
    np.testing.assert_array_equal(res.approx.halfwidth[ids],
                                  lone[0].halfwidth)


# ------------------------------------------------- test_qos.py mirrors
def test_request_validates_tier():
    with pytest.raises(ValueError, match="priority"):
        BCRequest(rid=0, graph="web", priority="urgent")


def test_request_validates_rid_and_seed():
    with pytest.raises(ValueError, match="non-negative"):
        BCRequest(rid=-1, graph="web")
    with pytest.raises(ValueError, match="non-negative"):
        BCRequest(rid=0, graph="web", seed=-3)


def test_edf_admission_prioritizes_tight_deadlines():
    g = _graph()
    for pack, first in (("fifo", 0), ("deadline", 2)):
        svc = _svc({"web": g}, n_slots=1, pack=pack)
        svc.submit(BCRequest(rid=0, graph="web", eps=0.2, priority="batch"))
        svc.submit(BCRequest(rid=1, graph="web", eps=0.2, priority="batch"))
        svc.submit(BCRequest(rid=2, graph="web", eps=0.2,
                             priority="interactive"))
        out = svc.run()
        assert [r.rid for r in out][0] == first, pack
        assert sorted(r.rid for r in out) == [0, 1, 2]


def test_edf_aging_overdue_batch_wins():
    svc = _svc({"web": _graph()}, n_slots=1, pack="deadline")
    svc.submit(BCRequest(rid=0, graph="web", eps=0.2, priority="batch",
                         deadline_s=0.0))
    svc.submit(BCRequest(rid=1, graph="web", eps=0.2,
                         priority="interactive"))
    out = svc.run()
    assert [r.rid for r in out][0] == 0


def test_untiered_requests_keep_fifo_order():
    svc = _svc({"web": _graph()}, n_slots=1, pack="deadline")
    for rid in range(3):
        svc.submit(BCRequest(rid=rid, graph="web", eps=0.2))
    assert [q.rid for q in svc.pending] == [0, 1, 2]
    out = svc.run()
    assert [r.rid for r in out] == [0, 1, 2]


def test_concurrent_identical_requests_draw_distinct_streams():
    g = _graph()

    def run_pair():
        svc = _svc({"web": g}, n_slots=2)
        svc.submit(BCRequest(rid=0, graph="web", eps=0.1))
        svc.submit(BCRequest(rid=1, graph="web", eps=0.1))
        return {r.rid: r for r in svc.run()}

    a, b = run_pair(), run_pair()
    assert not np.array_equal(a[0].lam, a[1].lam)
    np.testing.assert_allclose(a[0].lam, a[1].lam, rtol=0.9)
    for rid in (0, 1):
        np.testing.assert_array_equal(a[rid].lam, b[rid].lam)
        assert a[rid].topk == b[rid].topk


def test_first_epoch_draws_differ_across_rids():
    svc = _svc({"web": _graph()}, n_slots=2)
    svc.submit(BCRequest(rid=7, graph="web", eps=0.1, seed=3))
    svc.submit(BCRequest(rid=8, graph="web", eps=0.1, seed=3))
    svc._admit()
    s0 = svc.slots[0].sampler.draw(64)
    s1 = svc.slots[1].sampler.draw(64)
    assert not np.array_equal(s0, s1)


def test_tick_budget_preempts_and_preserves_answers():
    s = star_graph(64)

    def run(budget):
        svc = _svc({"s": s}, n_slots=2, pack="deadline", tick_budget=budget)
        svc.submit(BCRequest(rid=0, graph="s", eps=0.02, priority="batch"))
        svc.submit(BCRequest(rid=1, graph="s", eps=0.05,
                             priority="interactive"))
        if budget is not None:
            svc.step()
            assert any(job is not None and job.backlog.size
                       for job in svc.slots)
        out = svc.run()
        assert not svc.exhausted
        return {r.rid: r for r in out}

    base, budgeted = run(None), run(16)
    for rid in (0, 1):
        np.testing.assert_array_equal(base[rid].lam, budgeted[rid].lam)
        np.testing.assert_array_equal(base[rid].halfwidth,
                                      budgeted[rid].halfwidth)
        assert base[rid].n_samples == budgeted[rid].n_samples
        assert base[rid].topk == budgeted[rid].topk


def test_fifo_drain_follows_admission_order_not_slot_index():
    svc = _svc({"web": _graph()}, n_slots=2, pack="fifo", tick_budget=4)
    for rid in range(3):
        svc.submit(BCRequest(rid=rid, graph="web", eps=0.3))
    svc._admit()
    assert [j.req.rid for j in svc.slots] == [0, 1]
    svc.slots[0] = None  # rid 0 retires; rid 2 recycles slot 0
    svc._admit()
    assert [j.req.rid for j in svc.slots] == [2, 1]
    svc.step()
    assert svc.slots[1].est.tau == 4
    assert svc.slots[0].est.tau == 0


def test_tick_budget_validation():
    with pytest.raises(ValueError, match="tick_budget"):
        _svc({}, tick_budget=0)
    with pytest.raises(ValueError, match="pack"):
        _svc({}, pack="lifo")


def test_response_and_plan_carry_tier():
    g = _graph()
    svc = _svc({"web": g}, n_slots=1)
    svc.submit(BCRequest(rid=0, graph="web", eps=0.2,
                         priority="interactive"))
    r = svc.run()[0]
    assert r.tier == "interactive"
    assert r.plan.tier == "interactive"
    assert r.plan.to_json()["tier"] == "interactive"
    assert r.latency_s >= r.seconds - 1e-9
    svc2 = _svc({"web": g}, n_slots=2)
    svc2.submit(BCRequest(rid=0, graph="web", eps=0.2, priority="batch"))
    svc2.submit(BCRequest(rid=1, graph="web", eps=0.2,
                          priority="interactive"))
    by = {r.rid: r for r in svc2.run()}
    assert by[0].plan.tier == "batch" and by[1].plan.tier == "interactive"


def test_fair_pack_serves_all_tenants():
    svc = _svc({"web": _graph()}, n_slots=4, pack="fair", tick_budget=64)
    for i in range(4):
        svc.submit(BCRequest(rid=i, graph="web", eps=0.15,
                             tenant=f"t{i % 2}"))
    out = svc.run()
    assert sorted(r.rid for r in out) == [0, 1, 2, 3]
    assert all(r.converged for r in out)
    assert set(svc._served) == {"t0", "t1"}


@pytest.mark.parametrize("cap", [0, 1])
def test_zero_and_one_sample_caps_retire_honestly(cap):
    g = _graph()
    eps, delta = 0.3, 0.1
    assert cap < hoeffding_budget(g.n, eps, delta)
    svc = _svc({"web": g}, n_slots=1)
    svc.submit(BCRequest(rid=0, graph="web", eps=eps, delta=delta,
                         max_samples=cap))
    out = svc.run(max_ticks=50)
    assert not svc.exhausted and len(out) == 1
    r = out[0]
    assert r.n_samples == cap
    assert not r.converged
    assert np.isinf(r.halfwidth).all()
    assert not np.isnan(r.lam).any()
    assert r.plan.sample_budget == cap


@pytest.mark.parametrize("cap", [0, 1])
def test_zero_and_one_sample_caps_through_solve(cap):
    res = solve(_graph(), BCQuery(mode="approx", eps=0.3, delta=0.1,
                                  max_samples=cap), device="cpu")
    assert res.approx.n_samples == cap
    assert not res.converged
    assert np.isinf(res.approx.halfwidth).all()
    assert not np.isnan(res.lam).any()


# ------------------------------------- test_metrics.py service mirrors
def _serve(reqs, **kw):
    svc = _svc({"web": _graph()}, n_slots=4, **kw)
    for r in reqs:
        svc.submit(r)
    out = {r.rid: r for r in svc.run()}
    assert not svc.exhausted
    return out


def test_service_mixed_metrics_equal_isolated_runs():
    """A mixed-metric run retires every request with the answer a run
    holding only that request gives: bitwise for every metric (the
    reference holds betweenness to rtol 1e-5)."""
    reqs = [
        BCRequest(rid=0, graph="web", eps=0.1, delta=0.1, seed=3),
        BCRequest(rid=1, graph="web", eps=0.1, delta=0.1, seed=3,
                  metric="closeness"),
        BCRequest(rid=2, graph="web", eps=0.1, delta=0.1, seed=3,
                  metric="khop", hops=2),
    ]
    together = _serve(reqs)
    assert len(together) == 3
    for req in reqs:
        alone = _serve([req])[req.rid]
        mixed = together[req.rid]
        assert mixed.n_samples == alone.n_samples
        assert mixed.n_epochs == alone.n_epochs
        assert mixed.converged == alone.converged
        assert mixed.topk == alone.topk
        np.testing.assert_array_equal(mixed.lam, alone.lam)
        np.testing.assert_array_equal(mixed.halfwidth, alone.halfwidth)


def test_service_components_answers_immediately():
    svc = _svc({"web": _graph()}, n_slots=1)
    svc.submit(BCRequest(rid=0, graph="web", eps=0.02, delta=0.1))
    svc.step()  # rid 0 occupies the only slot
    assert svc.active == 1
    svc.submit(BCRequest(rid=1, graph="web", metric="components"))
    svc.step()
    done = {r.rid for r in svc.finished}
    assert 1 in done  # answered while the slot was still busy
    cc = next(r for r in svc.finished if r.rid == 1)
    ref = cc_ref(_graph())
    ids = np.argsort(ref)[::-1][:10]
    np.testing.assert_array_equal(cc.lam, ref[ids])
    assert cc.converged and np.all(cc.halfwidth == 0.0)
    svc.run()


def test_service_plan_records_metric():
    out = _serve([BCRequest(rid=0, graph="web", eps=0.1, delta=0.1,
                            metric="closeness")])
    assert out[0].plan.to_json()["metric"] == "closeness"


# -------------------------------------- test_fusion.py service mirrors
def test_service_fused_vs_unfused_converge_same_quality():
    g = _graph()
    ref = brandes_bc(g)
    top = set(np.argsort(ref)[::-1][:10].tolist())
    for fuse in (False, True):
        svc = _svc({"web": g}, n_slots=4, fuse=fuse)
        for rid in range(4):
            svc.submit(BCRequest(rid=rid, graph="web", k=10,
                                 eps=0.05 + 0.03 * rid, rule="normal",
                                 seed=rid))
        out = svc.run()
        assert not svc.exhausted and svc.pending == []
        assert sorted(r.rid for r in out) == [0, 1, 2, 3]
        assert all(r.converged for r in out)
        by = {r.rid: r for r in out}
        assert len(top & set(by[0].topk)) >= 9
        assert all(r.plan is not None and r.plan.n_b > 0 for r in out)


def test_service_lone_request_bitwise_stable():
    g = _graph()
    res = {}
    for fuse in (False, True):
        svc = _svc({"web": g}, n_slots=2, fuse=fuse)
        svc.submit(BCRequest(rid=0, graph="web", k=10, rule="normal",
                             seed=3))
        res[fuse] = svc.run()[0]
    np.testing.assert_array_equal(res[True].lam, res[False].lam)
    np.testing.assert_array_equal(res[True].halfwidth, res[False].halfwidth)
    assert res[True].topk == res[False].topk
    assert res[True].n_samples == res[False].n_samples


def test_service_capped_run_not_reported_converged():
    g = _graph()
    eps, delta = 0.01, 0.05
    cap = 32
    assert cap < hoeffding_budget(g.n, eps, delta)
    svc = _svc({"web": g}, n_slots=1)
    svc.submit(BCRequest(rid=0, graph="web", eps=eps, delta=delta,
                         max_samples=cap))
    out = svc.run()
    assert len(out) == 1
    assert out[0].n_samples == cap
    assert not out[0].converged
    assert not honest_converged(LambdaEstimator(g.n, eps, delta, "normal"))


def test_service_run_surfaces_unfinished_work():
    svc = _svc({"web": _graph()}, n_slots=1)
    svc.submit(BCRequest(rid=1, graph="web", eps=0.01))
    svc.submit(BCRequest(rid=2, graph="web", eps=0.01))
    done = svc.run(max_ticks=1)
    assert svc.exhausted
    finished = {r.rid for r in done}
    assert sorted(q.rid for q in svc.pending) == \
        [r for r in (1, 2) if r not in finished]
    svc.run()
    assert not svc.exhausted and svc.pending == []


# --------------------- test_approx_bc.py / test_bc_api.py service mirrors
def test_bc_service_slot_scheduling():
    g = _graph(7)
    lam_ref = brandes_bc(g)
    g2 = ring_of_cliques(5, 5)
    svc = _svc({"web": g, "ring": g2}, n_slots=2)
    svc.submit(BCRequest(rid=0, graph="web", k=10, rule="normal"))
    svc.submit(BCRequest(rid=1, graph="ring", k=5, rule="normal"))
    svc.submit(BCRequest(rid=2, graph="web", k=3, eps=0.2, rule="normal"))
    out = svc.run()
    assert sorted(r.rid for r in out) == [0, 1, 2]
    assert all(r.converged for r in out)
    by_rid = {r.rid: r for r in out}
    top_ref = set(np.argsort(lam_ref)[::-1][:10].tolist())
    assert len(top_ref & set(by_rid[0].topk)) >= 9
    lam2 = brandes_bc(g2)
    top2 = set(np.argsort(lam2)[::-1][:5].tolist())
    assert len(top2 & set(by_rid[1].topk)) >= 4


def test_bc_service_rejects_unknown_graph():
    svc = _svc({}, n_slots=1)
    with pytest.raises(KeyError):
        svc.submit(BCRequest(rid=0, graph="nope"))


def test_service_exposes_plan():
    g = _graph()
    ref = brandes_bc(g)
    svc = _svc({"web": g, "ring": ring_of_cliques(4, 5)}, n_slots=2)
    pl = svc.plan_for("web")
    assert pl.placement == "single_host" and pl.mode == "approx"
    svc.submit(BCRequest(rid=0, graph="web", k=5, rule="normal"))
    out = svc.run()
    assert len(out) == 1 and out[0].converged
    top_ref = set(np.argsort(ref)[::-1][:5].tolist())
    assert len(top_ref & set(out[0].topk)) >= 4
