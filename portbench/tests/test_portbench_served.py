"""The served cell's driver (``drivers/served_sweep.py``), its check and
its three readers on the CPU.

* The closed loop through ``portbench/run.py --device cpu`` on a tiny
  R-MAT, untraced and traced, and a program whose responses carry no swept
  sources failing at once with no result.
* The check: sound answers pass; a λ̂ or a halfwidth moved by 1e-2, a τ
  that is not the count of the sources, a top k on the wrong side of the
  reference's k-th value, and stops that the rule does not allow (claimed
  too early, or short of the cap unclaimed) fail, in the check and, for a
  service that stops every request at its first check, in a run; the
  sample holds its sources, requests and tight ε. (The reference
  computed in bfloat16 in the program's place fails the limit at the
  cell's size on the card, ``tools/served_control.py``; at the sizes a
  test holds its top 10 stays near the limit.)
* The reference's moments: its M1 is ``brandes.batch_lambda``'s sum.
* The readers on a trace recorded from ``BCService`` under
  ``torch.profiler``, and on a program without the service's spans.
"""
from __future__ import annotations

import json

import numpy as np
import pytest

from conftest import REPO, last_json, make_root, run_cell
from portbench.drivers import served_sweep as S
from portbench.harness import graphs
from portbench.harness.result import LayerContext
from portbench.harness.spec import metric_reader
from portbench.harness.trace import DeviceTrace
from portbench.reference import sampled
from portbench.reference.brandes import batch_lambda
from portbench.reference.sampled import sampled_lambda, top_k

CELL = "tiny.serve"
REAL = "rmat20-serve.topk16"
READERS = ("stop_check_ms_per_batch", "serve_fold_ms_per_batch",
           "fused_pad_share")
CHECK = json.loads((REPO / "portbench" / "workloads"
                    / f"{REAL}.json").read_text())["check"]
LIMITS = CHECK["limits"]


def _config(scale: int) -> dict:
    cfg = json.loads((REPO / "portbench" / "configs"
                      / "rmat20-serve.json").read_text())
    return {**cfg, "name": "tiny_serve", "scale": scale}


def add_served_cell(root, scale: int = 8):
    """The served cell at a tiny scale, its warm-up a third as long, added
    the way a later change adds a cell: new files and new entries only."""
    (root / "portbench" / "configs" / "tiny_serve.json").write_text(
        json.dumps(_config(scale)))
    mix = json.loads((root / "portbench" / "traffic"
                      / "topk16.json").read_text())
    (root / "portbench" / "traffic" / "tiny_topk16.json").write_text(
        json.dumps({**mix, "warm_retired": mix["warm_retired"] // 3}))
    (root / "portbench" / "workloads" / f"{CELL}.json").write_text(
        json.dumps({"check": CHECK}))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny_serve", "source": "test",
                             "file": "portbench/configs/tiny_serve.json",
                             "reduced": [], "why": "t"})
    bench["workloads"].append({"name": CELL, "config": "tiny_serve",
                               "traffic": "tiny_topk16", "chips": 1,
                               "why": "test"})
    for m in bench["per_layer"]:
        if REAL in m.get("workloads", ()):
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return root


@pytest.fixture(scope="module")
def served_root(tmp_path_factory):
    return add_served_cell(make_root(tmp_path_factory.mktemp("served")))


def test_closed_loop_on_the_cpu_is_correct(served_root):
    rc, out, err = run_cell(served_root, CELL, seed=2**33 + 5, seconds=2.0)
    assert rc == 0, err
    res = last_json(out)
    assert res["correct"] is True and res["failed"] == 0, err
    assert res["attempted"] >= 4
    assert set(res["metrics"]) == {"teps", "setup_s"}
    assert set(res["checks"]) == set(LIMITS)
    assert res["checks"]["lam_rel_err"]["value"] < 1e-5
    assert res["checks"]["tau_mismatch"]["value"] == 0
    assert res["checks"]["topk_mismatch"]["value"] == 0
    assert "warm-up: " in err and " retired (" in err


def test_traced_run_reads_the_three_metrics(served_root):
    """And the CSR adjacency's hit rate over the fused batches' relaxes;
    the card's metrics read nothing on the CPU."""
    rc, out, err = run_cell(served_root, CELL, seed=12, seconds=1.0,
                            trace=1)
    assert rc == 0, err
    res = last_json(out)
    assert res["correct"] is True, err
    assert set(res["metrics"]) == set(READERS) | {"csr_compact_hit_rate"}
    assert 0 <= res["metrics"]["csr_compact_hit_rate"]["value"] <= 1
    m = {k: res["metrics"][k]["value"] for k in READERS}
    assert m["stop_check_ms_per_batch"] > 0
    assert m["serve_fold_ms_per_batch"] > 0
    assert 0 <= m["fused_pad_share"] < 1


def test_a_program_without_swept_sources_fails_at_once(served_root,
                                                       tmp_path):
    """The parent's program: its ``BCResponse`` has no ``sources``."""
    (tmp_path / "sitecustomize.py").write_text("""
import dataclasses
import repro_torch.serve.bc_service as B

fields = [(f.name, f.type, f) for f in dataclasses.fields(B.BCResponse)
          if f.name != "sources"]
B.BCResponse = dataclasses.make_dataclass("BCResponse", fields)
""")
    rc, out, err = run_cell(served_root, CELL, extra_path=[tmp_path],
                            timeout=60)
    assert rc != 0 and out.strip() == ""
    assert "carries no swept sources" in err
    assert "graph tiny_serve" not in err  # before the graph is loaded


def test_a_moved_answer_in_a_run_is_not_correct(served_root, tmp_path):
    (tmp_path / "sitecustomize.py").write_text("""
import repro_torch.approx.driver as D

def moved(orig):
    def top(self, k):
        ids, lam, hw = orig(self, k)
        return ids, lam * (1 + 1e-2), hw
    return top

D.LambdaEstimator.top = moved(D.LambdaEstimator.top)
""")
    rc, out, err = run_cell(served_root, CELL, seconds=0.5,
                            extra_path=[tmp_path])
    assert rc == 0, err
    res = last_json(out)
    assert res["correct"] is False and res["failed"] >= 1
    c = res["checks"]["lam_rel_err"]
    assert not c["value"] <= c["limit"]


def test_a_stop_at_the_first_check_in_a_run_is_not_correct(served_root,
                                                           tmp_path):
    (tmp_path / "sitecustomize.py").write_text("""
import repro_torch.serve.bc_service as B

orig = B.stopping_check

def first(est, eps, k, i, **kw):
    return True, orig(est, eps, k, i, **kw)[1]

B.stopping_check = first
""")
    rc, out, err = run_cell(served_root, CELL, seconds=0.5,
                            extra_path=[tmp_path])
    assert rc == 0, err
    res = last_json(out)
    assert res["correct"] is False and res["failed"] >= 1
    c = res["checks"]["stop_excess"]
    assert not c["value"] <= c["limit"]


# ------------------------------------------------------------- the check
@pytest.fixture(scope="module")
def answers():
    """Sound answers on a scale-9 cut of the cell's graph: the reference's
    own λ̂ and halfwidths at its top 10, over uniform sources, each
    claiming convergence at its last epoch (16, 16 + 32, …) where the rule
    allows it there, else at none; and the moments of each."""
    arcs = graphs.generate(_config(9))
    n, src, dst, w = arcs
    rng = np.random.default_rng(5)
    out, moments = [], []
    for rid, tau in enumerate((16, 48, 112, 240)):
        sources = rng.integers(0, n, tau).astype(np.int32)
        m1, m2 = sampled.sampled_moments(n, src, dst, w, sources)
        lam = m1 * (n / tau)
        top = top_k(lam, 10)
        hw = sampled.halfwidths(n, m1, m2, tau, 0.1)[top] * n * (n - 2)
        a = S.Answer(rid=rid, eps=0.05 if rid == 3 else 0.3, delta=0.1,
                     topk=top, lam=lam[top], halfwidth=hw, n_samples=tau,
                     n_epochs=rid + 1, converged=True, cap=None,
                     sources=sources)
        if S.stop_excess(a, n, m1, m2) > 0:
            a = S.Answer(**{**a.__dict__, "converged": False, "cap": tau})
        out.append(a)
        moments.append((m1, m2))
    return arcs, out, moments


def _checked(arcs, sample):
    checks, failed = S.check_answers(arcs, sample, LIMITS, device="cpu")
    return {k: v for k, v, _ in checks}, failed


def test_sound_answers_pass(answers):
    arcs, sample, _ = answers
    got, failed = _checked(arcs, sample)
    assert failed == 0
    assert got == {"lam_rel_err": pytest.approx(0.0, abs=1e-12),
                   "hw_rel_err": pytest.approx(0.0, abs=1e-12),
                   "tau_mismatch": 0.0, "topk_mismatch": 0.0,
                   "stop_excess": 0.0}
    assert any(a.converged for a in sample)


@pytest.mark.parametrize("field", ["lam", "halfwidth"])
def test_check_refuses_a_number_moved_by_1e_2(answers, field):
    arcs, sample, _ = answers
    moved = [S.Answer(**{**a.__dict__, field: a.__dict__[field] * (1 + 1e-2)})
             for a in sample]
    got, failed = _checked(arcs, moved)
    assert failed == len(sample)
    key = {"lam": "lam_rel_err", "halfwidth": "hw_rel_err"}[field]
    assert got[key] == pytest.approx(1e-2, rel=1e-6)


def test_check_refuses_a_tau_that_is_not_the_sources_count(answers):
    arcs, sample, _ = answers
    a = sample[1]
    bad = S.Answer(**{**a.__dict__, "n_samples": a.n_samples + 1})
    got, failed = _checked(arcs, [bad])
    assert failed == 1 and got["tau_mismatch"] == 1.0


def test_check_refuses_a_topk_off_the_references(answers):
    arcs, sample, _ = answers
    n, src, dst, w = arcs
    a = sample[3]
    ref = sampled_lambda(n, src, dst, w, a.sources)
    order = np.argsort(ref)[::-1]
    top = np.concatenate([order[:9], order[20:21]])  # the 21st for the 10th
    bad = S.Answer(**{**a.__dict__, "topk": top, "lam": ref[top]})
    got, failed = _checked(arcs, [bad])
    assert failed == 1 and got["topk_mismatch"] >= 1.0


def test_check_refuses_a_stop_the_rule_does_not_allow(answers):
    """Claimed at the first check, where the halfwidths of 16 sources at
    δ/2 are far above ε 0.05 and separate no top 10; or unclaimed short of
    the request's cap. At the Hoeffding budget any stop is legal."""
    arcs, sample, moments = answers
    n = arcs[0]
    early = S.Answer(**{**sample[0].__dict__, "eps": 0.05, "n_epochs": 1,
                        "converged": True})
    assert S.stop_excess(early, n, *moments[0]) > LIMITS["stop_excess"]
    got, failed = _checked(arcs, [early])
    assert failed == 1 and got["stop_excess"] > LIMITS["stop_excess"]
    a = sample[3]  # ε 0.05: its budget is past twice its τ
    short = S.Answer(**{**a.__dict__, "converged": False,
                        "cap": 2 * a.n_samples})
    assert S.stop_excess(short, n, *moments[3]) == pytest.approx(0.5)
    budget = sampled.hoeffding_budget(n, 0.05, 0.1)
    many = S.Answer(**{**early.__dict__,
                       "sources": np.zeros(budget, np.int32)})
    assert S.stop_excess(many, n, *moments[0]) == 0.0


def test_reference_moments_sum_as_batch_lambda(answers):
    arcs, sample, moments = answers
    a, (m1, m2) = sample[2], moments[2]
    want = sum(batch_lambda(*arcs, a.sources[lo:lo + 16])
               for lo in range(0, a.sources.size, 16))
    np.testing.assert_array_equal(m1, want)
    tau = a.sources.size
    assert np.all(m2 * tau >= m1 * m1 * (1 - 1e-12))  # Cauchy–Schwarz


def test_topk_violations_forgive_ties_within_the_limit():
    ref = np.array([9.0, 8.0, 5.0, 5.0 * (1 + 1e-4), 1.0])
    assert S.topk_violations(ref, np.array([0, 1, 2]), 3, 2e-3) == 0
    assert S.topk_violations(ref, np.array([0, 1, 3]), 3, 2e-3) == 0
    assert S.topk_violations(ref, np.array([0, 2, 3]), 3, 2e-3) == 1
    assert S.topk_violations(ref, np.array([0, 1, 4]), 3, 2e-3) == 1
    assert S.topk_violations(ref, np.array([2, 3, 4]), 3, 2e-3) == 3


def _answer(rid, eps, tau):
    return S.Answer(rid=rid, eps=eps, delta=0.1, topk=np.zeros(10, np.int64),
                    lam=np.zeros(10), halfwidth=np.zeros(10), n_samples=tau,
                    n_epochs=1, converged=True, cap=None,
                    sources=np.zeros(tau, np.int32))


@pytest.mark.parametrize("seed", [1, 2, 2**40 + 3])
def test_sample_holds_sources_requests_and_a_tight_eps(seed):
    taus = [(0.05, 3000), (0.3, 64), (0.1, 400), (0.4, 48)] * 6
    pool = [_answer(i, e, t) for i, (e, t) in enumerate(taus)]
    got = S.pick(pool, seed, CHECK)
    assert sum(a.n_samples for a in got) >= CHECK["sources"]
    assert len(got) >= CHECK["requests"]
    assert any(a.eps <= 0.1 for a in got)
    assert sum(a.n_samples for a in got) <= CHECK["max_sources"]
    assert len({a.rid for a in got}) == len(got)
    assert S.pick(pool, seed, CHECK) == got  # drawn from the seed
    loose = [a for a in pool if a.eps > 0.1][:3]  # too few: all of them
    assert {a.rid for a in S.pick(loose, seed, CHECK)} == {
        a.rid for a in loose}


# ------------------------------------------------------------ the readers
@pytest.fixture(scope="module")
def recorded():
    """A closed loop of 16 requests through ``BCService`` under
    ``torch.profiler`` on a scale-7 R-MAT: the snapshot and the sum of
    ``step()``'s returns."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch import tracing
    from repro_torch.graphs.formats import Graph

    n, src, dst, w = graphs.generate(_config(7))
    g = Graph(n, src, dst, w, directed=False, name="g")
    svc = S.service(type("C", (), {"config": _config(7),
                                   "config_name": "g"})(), g, "cpu")
    mix = json.loads((REPO / "portbench" / "traffic"
                      / "topk16.json").read_text())
    swept = 0
    with profile(activities=[ProfilerActivity.CPU]):
        for rid in range(16):
            svc.submit(S.request(mix, "g", rid, 9))
        while svc.queue or svc.active:
            swept += svc.step()
        snap = tracing.snapshot()
    return snap, swept


def _ctx(traced=True):
    dt = DeviceTrace(window_s=1.0, busy_s=0.5, ops=[], idle_by_host={})
    return LayerContext(batches=3, trace=dt if traced else None,
                        launches={}, product_shape=None, occupancy=None,
                        peak_window_bytes=0)


@pytest.fixture
def fake_snapshot(monkeypatch):
    from repro_torch import tracing

    def use(snap):
        monkeypatch.setattr(tracing, "snapshot", lambda clear=True: snap)
    return use


def test_readers_on_a_recorded_trace(recorded, fake_snapshot):
    snap, swept = recorded
    fake_snapshot(snap)
    batches = len(snap.named("batch"))
    got = {name: metric_reader(name)(_ctx()) for name in READERS}
    assert got["stop_check_ms_per_batch"] == pytest.approx(
        sum(s.host_ms for s in snap.named("serve.stop_check")) / batches)
    assert got["serve_fold_ms_per_batch"] == pytest.approx(
        sum(s.host_ms for s in snap.named("serve.fold")) / batches)
    launched = sum(s.attrs["rows"] for s in snap.named("batch"))
    assert snap.counters["serve.sources"] == swept
    assert got["fused_pad_share"] == pytest.approx(
        (launched - swept) / launched)


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_untraced_or_without_the_services_spans(
        recorded, fake_snapshot, name):
    from repro_torch import tracing

    snap, _ = recorded
    read = metric_reader(name)
    fake_snapshot(snap)
    assert read(_ctx(traced=False)) is None
    parent = tracing.Snapshot(
        [s for s in snap.spans if not s.name.startswith("serve.")],
        {k: v for k, v in snap.counters.items()
         if not k.startswith("serve.")})
    fake_snapshot(parent)
    assert read(_ctx()) is None
