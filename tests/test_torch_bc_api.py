"""The port's solver facade (``repro_torch.bc``) against ``repro.bc``.

* ``plan(...).to_json()`` equals the reference's for the same query, the
  same topology and no calibration: exact and approx, pinned and
  unpinned, one device and eight.
* ``solve`` exact λ matches ``repro.bc.solve`` and ``brandes_bc``; approx
  runs take the same number of samples and epochs, with λ̂ and the
  halfwidths within rtol 1e-5.
* ``resume_approx`` continues a checkpoint the reference wrote.
* Dense plans pass through ``solve`` by identity.
* COO, unpinned (CSR) and mesh plans run; what the port does not run yet
  names its slice of ROADMAP.md; the port never reads the reference's
  calibration.
* ``launch.bc_run --approx`` runs on the CPU and exits on a host without a
  card with the ``--device cpu`` hint.
"""
import contextlib
import json
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro.bc as jbc
import repro.approx.sampling as jsam
from repro.core import brandes_bc, cc_ref, closeness_ref, khop_ref
from repro.graphs.generators import rmat
import repro_torch.bc as tbc
from repro_torch.launch import bc_run
from repro_torch.launch.mesh import Mesh
from repro_torch.spgemm import cost_model as tcost
from repro_torch.spgemm.autotune import autotune, choose_bc_regime

_CACHE = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these graphs are tiny, and the suite runs
    several workers at once, whose thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(scale=6, weighted=False):
    key = ("g", scale, weighted)
    if key not in _CACHE:
        _CACHE[key] = rmat(scale, 8, seed=5, weighted=weighted,
                           max_weight=9).remove_isolated()[0]
    return _CACHE[key]


def _queries(mod):
    Q, X = mod.BCQuery, mod.ExecutionConfig
    dense = X(backend="dense")
    return {
        "exact": Q(),
        "exact_dense_nb16": Q(n_b=16, execution=dense),
        "exact_single_host": Q(execution=X(placement="single_host")),
        "approx": Q(mode="approx", eps=0.05, delta=0.1),
        "approx_dense_topk": Q(mode="approx", eps=0.05, delta=0.1, topk=10,
                               n_b=64, execution=dense),
        "approx_normal_cap": Q(mode="approx", eps=0.02, delta=0.05,
                               rule="normal", max_samples=100,
                               tier="interactive"),
        "approx_uniform_kernel": Q(mode="approx", strategy="uniform",
                                   execution=X(backend="dense",
                                               use_kernel=True)),
        "approx_coo": Q(mode="approx", execution=X(backend="coo")),
    }


def _json(p):
    return json.dumps(p.to_json(), sort_keys=True)


@pytest.mark.parametrize("qname", sorted(_queries(tbc)))
@pytest.mark.parametrize("n_devices", [1, 8])
@pytest.mark.parametrize("scale,weighted", [(6, False), (9, True)])
def test_plan_json_equals_reference(qname, n_devices, scale, weighted):
    g = _graph(scale, weighted)
    # a pinned COO backend on several devices falls back loudly in both
    warns = (pytest.warns(UserWarning, match="no distributed step")
             if qname == "approx_coo" and n_devices > 1
             else contextlib.nullcontext())
    with warns:
        ours = tbc.BCPlanner(calibration=None).plan(
            g, _queries(tbc)[qname], n_devices=n_devices)
    with warns:
        ref = jbc.BCPlanner(calibration=None).plan(
            g, _queries(jbc)[qname], n_devices=n_devices)
    assert _json(ours) == _json(ref)
    assert ours.summary() == ref.summary()
    assert tbc.BCPlan.from_json(json.loads(json.dumps(ours.to_json()))) \
        == ours


def test_plan_for_request_equals_reference():
    g = _graph()
    for eps in (0.03, 0.4):
        ours = tbc.plan_for_request(g, eps=eps, delta=0.1, tier="batch",
                                    n_devices=1,
                                    planner=tbc.BCPlanner(calibration=None))
        ref = jbc.plan_for_request(g, eps=eps, delta=0.1, tier="batch",
                                   n_devices=1,
                                   planner=jbc.BCPlanner(calibration=None))
        assert _json(ours) == _json(ref)


def test_decomposition_search_equals_reference():
    from repro.spgemm.autotune import autotune as jautotune
    from repro.spgemm.autotune import choose_bc_regime as jregime
    from repro.spgemm.cost_model import ProblemSizes

    sizes = ProblemSizes(nnz_a=4e8, nnz_b=3e6, nnz_c=3e6)
    tsizes = tcost.ProblemSizes(nnz_a=4e8, nnz_b=3e6, nnz_c=3e6)
    for axes in ({"data": 4}, {"data": 2, "model": 4},
                 {"pod": 2, "data": 2, "model": 2}):
        ours, ref = autotune(tsizes, axes), jautotune(sizes, axes)
        assert (ours.plan.variant, ours.plan.axes) == \
            (ref.plan.variant, ref.plan.axes)
        assert (ours.seconds, ours.bytes_moved, ours.mem_per_device) == \
            (ref.seconds, ref.bytes_moved, ref.mem_per_device)
    for nb, p in ((64, 1), (16, 8)):
        assert choose_bc_regime(3342, 97194, nb, 0.5, p=p, est_iters=26) == \
            jregime(3342, 97194, nb, 0.5, p=p, est_iters=26)


def test_planner_never_reads_the_reference_calibration(tmp_path,
                                                       monkeypatch):
    """A calibration in the reference's file or variable changes nothing
    in the port; the port's own variable does."""
    cal = {"version": 1, "meta": {},
           "rates": {k: {"ops_per_s": 1e9, "overhead_s": 1e-3}
                     for k in ("dense", "dense_kernel", "coo", "csr")}}
    f = tmp_path / "cal.json"
    f.write_text(json.dumps(cal))
    monkeypatch.chdir(tmp_path)
    (tmp_path / "results").mkdir()
    (tmp_path / "results" / "cost_calibration.json").write_text(
        json.dumps(cal))
    monkeypatch.setenv("REPRO_BC_CALIBRATION", str(f))
    monkeypatch.delenv(tcost.CALIBRATION_ENV, raising=False)
    assert tcost.load_calibration() is None
    g = _graph()
    q = tbc.BCQuery(mode="approx")
    auto = tbc.BCPlanner().plan(g, q, n_devices=1)
    assert _json(auto) == _json(tbc.BCPlanner(calibration=None).plan(
        g, q, n_devices=1))
    assert not auto.regime["calibrated"]
    monkeypatch.setenv(tcost.CALIBRATION_ENV, str(f))
    assert tcost.load_calibration() is not None
    assert tbc.BCPlanner().plan(g, q, n_devices=1).regime["calibrated"]


# ------------------------------------------------------------------ solve
_DENSE = dict(n_b=16)


def _pair_query(mode="exact", **kw):
    return (tbc.BCQuery(mode=mode, execution=tbc.ExecutionConfig(
                backend="dense"), **_DENSE, **kw),
            jbc.BCQuery(mode=mode, execution=jbc.ExecutionConfig(
                backend="dense", use_kernel=False), **_DENSE, **kw))


def _ref_solve(g, q):
    pl = jbc.BCPlanner(calibration=None).plan(g, q, n_devices=1)
    return jbc.solve(g, q, plan=pl)


@pytest.mark.parametrize("weighted", [False, True])
def test_solve_exact_matches_reference_and_brandes(weighted):
    g = _graph(6, weighted)
    tq, jq = _pair_query()
    ours = tbc.solve(g, tq, device="cpu")
    np.testing.assert_allclose(ours.lam, brandes_bc(g), rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(ours.lam, _ref_solve(g, jq).lam, rtol=1e-5,
                               atol=1e-8)
    assert ours.n_samples == g.n and ours.converged


def test_solve_exact_source_subset():
    g = _graph()
    srcs = np.array([0, 3, 7, 21, 30], np.int32)
    tq, _ = _pair_query()
    seen = []
    ours = tbc.solve(g, tq, sources=srcs, device="cpu",
                     progress_cb=lambda b, nb, lam: seen.append((b, nb)))
    np.testing.assert_allclose(ours.lam, brandes_bc(g, sources=srcs),
                               rtol=1e-5, atol=1e-8)
    assert ours.n_samples == 5 and seen == [(0, 1)]


@pytest.mark.parametrize("kw", [
    dict(eps=0.2, delta=0.1),
    dict(eps=0.15, delta=0.1, rule="normal", topk=5),
    dict(eps=0.05, delta=0.2, max_samples=40, seed=3),
    dict(eps=0.2, delta=0.1, strategy="uniform", seed=1),
], ids=["bernstein", "normal_topk", "capped", "uniform"])
def test_solve_approx_matches_reference(kw):
    g = _graph(6, True)
    tq, jq = _pair_query("approx", **kw)
    ours, ref = tbc.solve(g, tq, device="cpu").approx, _ref_solve(g, jq).approx
    assert (ours.n_samples, ours.n_epochs, ours.converged) == \
        (ref.n_samples, ref.n_epochs, ref.converged)
    np.testing.assert_allclose(ours.lam, ref.lam, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(ours.halfwidth, ref.halfwidth, rtol=1e-5)


def test_solve_passes_the_plan_through_by_identity():
    g = _graph()
    tq, _ = _pair_query("approx", eps=0.2, max_samples=32)
    pl = tbc.plan(g, tq, device="cpu")
    assert tbc.solve(g, tq, plan=pl, device="cpu").plan is pl
    ex = tbc.build_executor(g, pl, device="cpu")
    assert tbc.solve(g, tq, executor=ex).plan is pl
    assert tbc.solve(g, tbc.BCQuery(n_b=16), executor=ex).plan is pl


def _ref_checkpoint(g, n_b, eps, seed):
    """A checkpoint of a loose reference run, written by the reference's
    own ``resume_approx`` started from an empty checkpoint."""
    q = jbc.BCQuery(mode="approx", n_b=n_b, execution=jbc.ExecutionConfig(
        backend="dense", use_kernel=False))
    ex = jbc.build_executor(g, jbc.BCPlanner(calibration=None).plan(
        g, q, n_devices=1))
    empty = jbc.ApproxCheckpoint(
        n=g.n, eps=eps, delta=0.1, rule="normal", n_b=n_b,
        s1=np.zeros(g.n), s2=np.zeros(g.n), tau=0, n_epochs=0,
        sampler_state=jsam.AdaptiveSampler(g.n, n_b=n_b, seed=seed).state(),
        prefix_exact=True)
    return ex, jbc.resume_approx(ex, empty, eps=eps)[1]


def test_resume_approx_from_a_reference_checkpoint():
    g = _graph(6, True)
    ref_ex, ckpt = _ref_checkpoint(g, 16, eps=0.3, seed=7)
    assert ckpt.tau > 0 and ckpt.prefix_exact
    carried = tbc.carry_checkpoint(ckpt)
    assert isinstance(carried, tbc.ApproxCheckpoint)
    np.testing.assert_array_equal(carried.s1, ckpt.s1)
    tq = tbc.BCQuery(mode="approx", n_b=16, execution=tbc.ExecutionConfig(
        backend="dense"))
    ex = tbc.build_executor(g, tbc.plan(g, tq, device="cpu"), device="cpu")
    ours, ours_ck = tbc.resume_approx(ex, carried, eps=0.1)
    ref, ref_ck = jbc.resume_approx(ref_ex, ckpt, eps=0.1)
    assert (ours.n_samples, ours.n_epochs, ours.converged) == \
        (ref.n_samples, ref.n_epochs, ref.converged)
    assert ours.n_samples > ckpt.tau
    np.testing.assert_allclose(ours.lam, ref.lam, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(ours.halfwidth, ref.halfwidth, rtol=1e-5)
    assert ours_ck.sampler_state["drawn"] == ref_ck.sampler_state["drawn"]
    # the carried copy is independent of the reference's checkpoint
    carried.sampler_state["rng_state"]["state"]["state"] += 1
    assert ckpt.sampler_state != carried.sampler_state


def test_resume_equals_a_scratch_run_at_the_tighter_eps():
    """The port's own checkpoint: loose run → refine == scratch tight run
    over the same stream (the reference's resume contract)."""
    g = _graph(6, True)
    tq = tbc.BCQuery(mode="approx", n_b=16, seed=7, eps=0.1, rule="normal",
                     execution=tbc.ExecutionConfig(backend="dense"))
    ex = tbc.build_executor(g, tbc.plan(g, tq, device="cpu"), device="cpu")
    empty = tbc.carry_checkpoint(_ref_checkpoint(g, 16, eps=0.3, seed=7)[1])
    empty.s1[:], empty.s2[:], empty.tau, empty.n_epochs = 0.0, 0.0, 0, 0
    empty.sampler_state = tbc.AdaptiveSampler(g.n, n_b=16, seed=7).state()
    loose, loose_ck = tbc.resume_approx(ex, empty, eps=0.3)
    assert loose.converged and loose_ck.prefix_exact
    refined, _ = tbc.resume_approx(ex, loose_ck, eps=0.1)
    scratch = tbc.solve(g, tq, executor=ex).approx
    assert refined.n_samples > loose.n_samples
    assert (refined.n_samples, refined.n_epochs) == \
        (scratch.n_samples, scratch.n_epochs)
    np.testing.assert_array_equal(refined.lam, scratch.lam)
    np.testing.assert_array_equal(refined.halfwidth, scratch.halfwidth)


# ------------------------------------------------------- unported surface
def test_unported_paths_name_their_slice():
    g = _graph()
    planner = tbc.BCPlanner(calibration=None)
    # slice 3 is ported: a COO plan and an unpinned (CSR) plan run
    coo = planner.plan(g, tbc.BCQuery(execution=tbc.ExecutionConfig(
        backend="coo")), n_devices=1)
    ex = tbc.build_executor(g, coo, device="cpu")
    assert ex.occupancy_summary() is None
    unpinned = planner.plan(g, tbc.BCQuery(), n_devices=1)
    assert unpinned.backend == "csr"  # the analytic regime on R-MAT
    exact = tbc.solve(g, tbc.BCQuery(), plan=unpinned, device="cpu")
    np.testing.assert_allclose(exact.lam, brandes_bc(g), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(tbc.solve(g, tbc.BCQuery(), plan=coo,
                                         device="cpu").lam,
                               exact.lam, rtol=1e-5, atol=1e-8)
    # slice 6 is ported: a mesh plan runs on a mesh of torch.distributed
    # ranks, and says what it needs when there is none of its size
    dense16 = tbc.BCQuery(n_b=16, execution=tbc.ExecutionConfig(
        backend="dense"))
    mesh = planner.plan(g, dense16, n_devices=8)
    assert mesh.placement == "mesh"
    with pytest.raises(RuntimeError, match="init_process_group"):
        tbc.build_executor(g, mesh, device="cpu")
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 8 ranks"):
            tbc.build_executor(g, mesh, device="cpu")
        one = Mesh((1, 1), ("data", "model"), device="cpu")
        on_mesh = tbc.solve(g, dense16, mesh=one, device="cpu")
        assert on_mesh.plan.placement == "mesh"
        np.testing.assert_array_equal(
            on_mesh.lam, tbc.solve(g, dense16, device="cpu").lam)
    finally:
        dist.destroy_process_group()
    # slice 4 is ported: every metric runs, against its oracle
    dense = tbc.BCQuery(n_b=16, execution=tbc.ExecutionConfig(
        backend="dense"))
    oracles = {"closeness": closeness_ref(g), "khop": khop_ref(g, hops=2),
               "components": cc_ref(g)}
    for metric, hops in (("closeness", 0), ("khop", 2), ("components", 0)):
        q = tbc.BCQuery(metric=metric, hops=hops, n_b=16,
                        execution=tbc.ExecutionConfig(backend="dense"))
        np.testing.assert_allclose(tbc.solve(g, q, device="cpu").lam,
                                   oracles[metric], rtol=1e-5)
    ex = tbc.build_executor(g, tbc.plan(g, dense, device="cpu"),
                            device="cpu")
    one = np.array([0, 3, 5, 7], np.int32), np.ones(4, bool)
    np.testing.assert_allclose(ex.step(*one, metric="closeness")[0],
                               closeness_ref(g, sources=one[0]), rtol=1e-5)
    np.testing.assert_array_equal(ex.step_sum(*one, metric="khop", hops=2),
                                  khop_ref(g, sources=one[0], hops=2))
    np.testing.assert_allclose(
        ex.step_segmented(*one, np.zeros(4, np.int32), 1,
                          metrics=["closeness"])[0][0],
        closeness_ref(g, sources=one[0]), rtol=1e-5)


def test_query_has_no_deprecated_keywords():
    """The reference's legacy ``backend=``/``use_kernel=``/``block=``
    shims are not ported: ``execution=`` is the one way to pin."""
    for kw in ("backend", "use_kernel", "block"):
        with pytest.raises(TypeError):
            tbc.BCQuery(**{kw: None})
    with pytest.raises(TypeError):
        tbc.plan_for_request(_graph(), eps=0.1, delta=0.1, backend="dense")
    assert tbc.BCQuery().execution == tbc.ExecutionConfig()


def test_planner_counts_cards_only_for_the_card(monkeypatch):
    g = _graph()
    q = tbc.BCQuery(n_b=16, execution=tbc.ExecutionConfig(backend="dense"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert tbc.plan(g, q, device="cpu").placement == "single_host"
    assert tbc.plan(g, q, device="cuda").placement == "mesh"
    pinned = tbc.BCQuery(n_b=16, execution=tbc.ExecutionConfig(
        backend="dense", placement="single_host"))
    assert tbc.plan(g, pinned, device="cuda").placement == "single_host"


# -------------------------------------------------------------------- CLI
def test_bc_run_approx_verifies_on_cpu(capsys):
    res = bc_run.main(["--scale", "5", "--approx", "0.1,0.1", "--device",
                       "cpu", "--verify"])
    out = capsys.readouterr().out
    assert "BCPlan[approx] single_host backend=dense" in out
    assert "vs Brandes oracle" in out and "WARNING" not in out
    assert res.n_samples > 0 and res.n_epochs > 0


def test_bc_run_without_a_card_names_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="--device cpu"):
        bc_run.main(["--scale", "3", "--approx", "0.1,0.1"])


@pytest.mark.parametrize("argv,slice_", [
    # the analytic regime routes scale-8 R-MAT to CSR, which runs since
    # slice 3 (None: no slice to name)
    (["--backend", "auto", "--nb", "0", "--scale", "8"], None),
    # slice 6 is ported: a one-rank mesh, as one rank of torchrun sees it
    (["--mesh", "1x1", "--approx", "0.1,0.1", "--dist-backend", "gloo"],
     None),
    # slice 4 is ported: the metric runs and passes its own oracle
    (["--metric", "closeness"], None),
    # slice 7's checkpoints are ported: a run killed after batch 1
    # resumes at batch 2 (the id is the one the case had when it named
    # its slice)
    pytest.param(["--ckpt-dir", "ck", "--nb", "8"], None,
                 id="argv3-slice 7"),
])
def test_bc_run_unported_options_name_their_slice(argv, slice_, capsys,
                                                  monkeypatch, tmp_path):
    argv = ["--scale", "5", "--device", "cpu"] + argv
    if slice_ is not None:
        with pytest.raises(SystemExit, match=slice_):
            bc_run.main(argv)
        return
    if "--ckpt-dir" in argv:
        import shutil

        from repro_torch.train import checkpoint as ckpt_lib

        ck = tmp_path / "ck"
        argv[argv.index("ck")] = str(ck)
        bc_run.main(argv)
        for s in ckpt_lib.all_steps(str(ck)):
            if s > 1:
                shutil.rmtree(ck / f"step_{s:010d}")
        bc_run.main(argv + ["--verify"])
        out = capsys.readouterr().out
        assert "resuming at batch 2 (nb=8)" in out
        assert "verified against the Brandes oracle" in out
        return
    if "--mesh" in argv:
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        for key, val in (("MASTER_ADDR", "127.0.0.1"),
                         ("MASTER_PORT", str(port)), ("RANK", "0"),
                         ("WORLD_SIZE", "1")):
            monkeypatch.setenv(key, val)
        res = bc_run.main(argv + ["--verify"])
        out = capsys.readouterr().out
        assert "BCPlan[approx] mesh{'data': 1, 'model': 1} backend=dense" \
            in out
        assert "vs Brandes oracle" in out and "WARNING" not in out
        assert res.n_samples > 0 and not dist.is_initialized()
        return
    lam = bc_run.main(argv + ["--verify"])
    out = capsys.readouterr().out
    oracle = "closeness_ref" if "closeness" in argv else "the Brandes"
    assert f"verified against {oracle} oracle" in out
    assert "--backend" not in argv or "backend=csr" in out
    assert np.all(np.isfinite(lam))
