"""The served top-k cell's program path on the CPU: ``BCService`` with 16
slots, fusion, deadline packing and no tick budget, serving a closed loop
of approximate top-10 requests over ``benchmarks/bc_serve.py``'s ε mix on
a Graph500 R-MAT (A, B, C = 0.57, 0.19, 0.19) at scale 10, edge factor
4, with weights 1–100.

* Each retired answer against the benchmark's plain reference
  (``portbench/reference/sampled.py``, float64 Brandes over the sources
  the response says it swept): the whole λ̂ (n/τ · S1, from the
  response's checkpoint) and the reported top-k λ̂ at rtol 1e-5, atol
  1e-8, the port's λ tolerance; τ is the number of swept sources; the
  top k is the reference's.
* The service's spans and counters under ``torch.profiler``:
  ``serve.sources`` is the sum of ``step()``'s returns, ``serve.pad_rows``
  the rows the executor's ``batch`` spans launched less the valid ones,
  one ``serve.stop_check`` per epoch boundary, one ``serve.tick`` per
  tick, one ``serve.fold`` per batch, ``serve.retired`` per answer.
* Fusion: rid 0 (ε 0.05, the tightest deadline, so it drains first in
  every tick and its epochs fill whole batches) retires fused with the
  λ̂ it gets alone under ``fuse=False``, bitwise.
* The epoch-boundary test the service runs on its card
  (``stopping_check(..., device=)``), here on the CPU's torch and, with
  ``-m cuda``, on the card: the host's decision around the largest
  halfwidth and at a tie, and the host deciding within the margin.
"""
import copy
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

from portbench.reference.sampled import sampled_lambda  # noqa: E402
from repro_torch import tracing  # noqa: E402
from repro_torch.approx import driver as tdrv  # noqa: E402
from repro_torch.graphs.generators import rmat  # noqa: E402
from repro_torch.serve.bc_service import BCRequest, BCService  # noqa: E402

EPS_MIX = (0.05, 0.3, 0.1, 0.4)  # benchmarks/bc_serve.py's
LIVE = 16
TOTAL = 20  # requests the closed loop submits: 16 at once, 4 as slots free
SEED = 4294967311  # past 32 bits, as the benchmark's seeds are


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the suite runs several workers at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _request(rid):
    return BCRequest(rid=rid, graph="g", k=10, eps=EPS_MIX[rid % 4],
                     delta=0.1, rule="normal", seed=SEED)


def _service(g, fuse=True):
    return BCService({"g": g}, n_slots=16, fuse=fuse, pack="deadline",
                     tick_budget=None, checkpoints=True, device="cpu")


@pytest.fixture(scope="module")
def served():
    """The closed loop, profiled: the graph, the responses by rid, the
    sum of ``step()``'s returns, the tick count and the snapshot."""
    torch.set_num_threads(1)
    g = rmat(10, 4, seed=3, weighted=True, max_weight=100)
    g = g.remove_isolated()[0]
    svc = _service(g)
    nxt = swept = ticks = 0
    with profile(activities=[ProfilerActivity.CPU]):
        while nxt < LIVE:
            svc.submit(_request(nxt))
            nxt += 1
        while svc.queue or svc.active:
            swept += svc.step()
            ticks += 1
            while nxt < TOTAL and nxt - len(svc.finished) < LIVE:
                svc.submit(_request(nxt))
                nxt += 1
        snap = tracing.snapshot()
    assert len(svc.finished) == TOTAL
    by = {r.rid: r for r in svc.finished}
    ref = {rid: sampled_lambda(g.n, g.src, g.dst, g.w, r.sources)
           for rid, r in by.items()}
    return dict(g=g, by=by, ref=ref, swept=swept, ticks=ticks, snap=snap,
                n_b=svc.executor_for("g").n_b)


def test_every_answer_is_the_plain_estimate_over_its_swept_sources(served):
    g = served["g"]
    for rid, resp in served["by"].items():
        ref = served["ref"][rid]
        ck = resp.checkpoint
        np.testing.assert_allclose(ck.s1 * (g.n / ck.tau), ref, rtol=1e-5,
                                   atol=1e-8)
        np.testing.assert_allclose(resp.lam, ref[resp.topk], rtol=1e-5,
                                   atol=1e-8)


def test_tau_is_the_number_of_swept_sources(served):
    for resp in served["by"].values():
        assert resp.sources.dtype == np.int32
        assert resp.n_samples == resp.checkpoint.tau == resp.sources.size > 0
        assert 0 <= resp.sources.min() and resp.sources.max() < served["g"].n


def test_topk_is_the_references(served):
    for rid, resp in served["by"].items():
        ref = served["ref"][rid]
        order = np.argsort(ref)[::-1]
        kth, nxt = ref[order[9]], ref[order[10]]
        if kth - nxt > 1e-5 * max(kth, 1.0):
            assert set(resp.topk) == set(order[:10].tolist())
        else:  # tied at the boundary: the ids above it must be there
            tol = 1e-5 * max(kth, 1.0)
            assert set(np.nonzero(ref > kth + tol)[0]) <= set(resp.topk)
            assert (ref[resp.topk] >= kth - tol).all()


def test_the_mix_and_the_closed_loop(served):
    by = served["by"]
    assert sorted(by) == list(range(TOTAL))
    checks = served["snap"].named("serve.stop_check")
    assert {c.attrs["eps"] for c in checks} == set(EPS_MIX)
    # the tightest requests sweep more than the loosest
    assert by[0].n_samples > by[3].n_samples


def test_sources_counter_is_the_sum_of_step_returns(served):
    c = served["snap"].counters
    assert c["serve.sources"] == served["swept"] == sum(
        r.n_samples for r in served["by"].values())


def test_pad_rows_counter_is_rows_launched_less_valid_rows(served):
    snap = served["snap"]
    launched = sum(s.attrs["rows"] for s in snap.named("batch"))
    assert snap.counters["serve.pad_rows"] == launched - served["swept"]
    assert snap.counters["serve.pad_rows"] >= 0


def test_one_stop_check_per_epoch_boundary(served):
    checks = served["snap"].named("serve.stop_check")
    assert len(checks) == sum(r.n_epochs for r in served["by"].values())
    assert all(c.attrs["tau"] > 0 for c in checks)


def test_tick_fold_and_retired_counts(served):
    snap = served["snap"]
    ticks = snap.named("serve.tick")
    assert len(ticks) == served["ticks"]
    assert ticks[0].attrs == {"active": 0, "queued": LIVE}
    assert len(snap.named("serve.fold")) == len(snap.named("batch"))
    assert snap.counters["serve.retired"] == TOTAL
    parents = {s.id: s.name for s in snap.spans}
    for s in snap.named("serve.fold") + snap.named("serve.stop_check"):
        assert parents[s.parent] == "serve.tick"


def test_fused_answer_is_bitwise_the_unfused_one(served):
    g, fused = served["g"], served["by"][0]
    svc = _service(g, fuse=False)
    svc.submit(_request(0))
    alone = svc.run()[0]
    assert svc.executor_for("g").n_b == served["n_b"]
    assert alone.topk == fused.topk and alone.n_samples == fused.n_samples
    np.testing.assert_array_equal(alone.sources, fused.sources)
    np.testing.assert_array_equal(alone.checkpoint.s1, fused.checkpoint.s1)
    np.testing.assert_array_equal(alone.lam, fused.lam)
    np.testing.assert_array_equal(alone.halfwidth, fused.halfwidth)


# ------------------------------------------- the check on the device
def _hub_estimator(rule, n=300, tie=False):
    """An estimator whose 10 hubs stand clear of the rest (their top 10
    separates long before the largest halfwidth reaches a small ε), the
    10th and 11th estimates equal where ``tie``."""
    rng = np.random.default_rng(7)
    est = tdrv.LambdaEstimator(n, 0.05, 0.1, rule)
    for i in range(3):
        tau = 16 << i
        d = rng.random((tau, n)) ** 3
        d[:, :10] = (n - 2) * (0.5 + 0.05 * np.arange(10) / 10
                               + 0.01 * rng.random((tau, 10)))
        est.update(d.sum(axis=0), (d * d).sum(axis=0), tau)
    if tie:  # vertex 10 as high as the lowest hub
        est.s1[10] = est.s1[:10].min()
    return est


@pytest.mark.parametrize("rule", ["bernstein", "normal"])
@pytest.mark.parametrize("topk", [None, 3, 10, 300])
@pytest.mark.parametrize("tie", [False, True])
@pytest.mark.parametrize("at", [0.5, 1 - 1e-6, 1.0, 1 + 1e-6, 2.0])
def test_check_on_a_device_decides_as_the_host(rule, topk, tie, at):
    """The stopping test evaluated on a device (here the CPU's torch)
    gives the host's decision at every ε around the largest halfwidth,
    records its largest halfwidth to 1e-12, and leaves the decision to
    the host, returning the host's halfwidths, where ε is that maximum."""
    est = _hub_estimator(rule, tie=tie)
    host = copy.deepcopy(est)
    ei = 2
    hw_max = host.halfwidth_normalized(
        delta=host.delta / 2.0 ** (ei + 1)).max()
    eps = float(hw_max * at)
    want, want_hw = tdrv.stopping_check(host, eps, topk, ei)
    got, got_hw = tdrv.stopping_check(est, eps, topk, ei,
                                      device=torch.device("cpu"))
    assert got == want
    if at == 1.0:
        np.testing.assert_array_equal(got_hw, want_hw)
        assert est.hw_history == host.hw_history
    else:
        assert got_hw is None
        (tau, m), = est.hw_history
        assert tau == host.hw_history[0][0]
        np.testing.assert_allclose(m, host.hw_history[0][1], rtol=1e-12)


def test_check_on_a_device_sees_the_hubs_separate():
    """Both branches of the test are reached on the device: the top 10
    separates below the largest halfwidth, a tie at the 10th does not."""
    for tie, want in ((False, True), (True, False)):
        est = _hub_estimator("normal", tie=tie)
        hw = est.halfwidth_normalized(delta=est.delta / 8.0)
        assert tdrv.stopping_check(est, float(hw.max()) / 2, 10, 2,
                                   device=torch.device("cpu")) == (want,
                                                                    None)


def test_check_on_a_device_defers_a_close_separation(monkeypatch):
    """A top-k separation within the margin (here widened to 0.9 of the
    estimates' scale) is left to the host: its halfwidths come back."""
    monkeypatch.setattr(tdrv, "DEVICE_MARGIN", 0.9)
    est = _hub_estimator("normal")
    host = copy.deepcopy(est)
    eps = float(est.halfwidth_normalized(delta=est.delta / 8.0).max()) / 2
    got, hw = tdrv.stopping_check(est, eps, 10, 2, device=torch.device("cpu"))
    want, want_hw = tdrv.stopping_check(host, eps, 10, 2)
    assert got == want is True
    np.testing.assert_array_equal(hw, want_hw)
    assert est.hw_history == host.hw_history


@pytest.mark.cuda
@pytest.mark.skipif(not torch.cuda.is_available(),
                    reason="needs an NVIDIA card")
@pytest.mark.parametrize("rule", ["bernstein", "normal"])
@pytest.mark.parametrize("topk", [None, 10])
def test_check_on_the_card_decides_as_the_host(rule, topk):
    for tie in (False, True):
        for at in (0.5, 1 - 1e-6, 1.0, 1 + 1e-6, 2.0):
            est = _hub_estimator(rule, n=3 * tdrv.CHUNK, tie=tie)
            host = copy.deepcopy(est)
            hw_max = host.halfwidth_normalized(delta=host.delta / 8.0).max()
            eps = float(hw_max * at)
            want, _ = tdrv.stopping_check(host, eps, topk, 2)
            got, _ = tdrv.stopping_check(est, eps, topk, 2,
                                         device=torch.device("cuda"))
            assert got == want
            np.testing.assert_allclose(est.hw_history[0][1],
                                       host.hw_history[0][1], rtol=1e-12)
