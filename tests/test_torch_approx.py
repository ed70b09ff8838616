"""The port's sampled path against the JAX package on identical inputs.

* Sampler streams (``AdaptiveSampler``, ``UniformSampler``) are bitwise the
  reference's for the same ``(seed, rid)``, ``n_b``, cap and chunking, and
  a ``state()`` snapshot resumes both the same way.
* ``hoeffding_budget``, ``allocate_delta``, both halfwidth rules, the
  estimator and ``stopping_check`` give the reference's numbers exactly
  from the same ``(S1, S2, τ)`` (the same numpy code in both packages).
* The moments and segmented batch steps of ``core.mfbc`` match
  ``repro.core.mfbc`` at rtol 1e-5, atol 1e-8, with ``n_reach`` bitwise,
  and the segmented fold is bitwise a fold of each slot's rows alone.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.approx.driver as jdrv
import repro.approx.sampling as jsam
from repro.core import dense_adj_from_graph as jax_dense_adj
from repro.core.mfbc import mfbc_batch_moments as jax_moments
from repro.core.mfbc import mfbc_batch_moments_segmented as jax_segmented
from repro.graphs.generators import erdos_renyi, rmat
import repro_torch.approx.driver as tdrv
import repro_torch.approx.sampling as tsam
from repro_torch.core.adjacency import dense_adj_from_arrays
from repro_torch.core.mfbc import (metric_batch_moments,
                                   metric_batch_moments_segmented,
                                   segment_fold)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these graphs are tiny, and the suite runs
    several workers at once, whose thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------- streams
def _epoch_stream(mod, n, seed, n_b, cap, stop_after):
    s = mod.AdaptiveSampler(n, eps=0.1, delta=0.1, n_b=n_b, cap=cap,
                            seed=seed)
    out = []
    for ei, batches in s.epochs():
        for b in batches:
            out.append((b.epoch, b.sources.copy(), b.valid.copy()))
        if ei == stop_after:
            s.stop()
    return out, s.drawn


@pytest.mark.parametrize("seed,n_b,cap", [(0, 16, None), ((3, 7), 8, 100),
                                          ((5, 0), 64, 1000), (11, 32, 0)])
def test_adaptive_stream_matches_reference(seed, n_b, cap):
    ours, drawn = _epoch_stream(tsam, 300, seed, n_b, cap, stop_after=3)
    ref, ref_drawn = _epoch_stream(jsam, 300, seed, n_b, cap, stop_after=3)
    assert drawn == ref_drawn and len(ours) == len(ref)
    for (e, s, v), (re_, rs, rv) in zip(ours, ref):
        assert e == re_
        np.testing.assert_array_equal(s, rs)
        np.testing.assert_array_equal(v, rv)


@pytest.mark.parametrize("chunks", [(64,), (7, 57), (1, 1, 62), (32, 32)])
def test_demand_side_chunking_matches_reference(chunks):
    """``next_epoch`` + ``draw`` in any chunking gives the reference's
    stream (what the fused assembler consumes)."""
    a = tsam.AdaptiveSampler(500, n_b=32, cap=400, seed=(9, 2))
    b = jsam.AdaptiveSampler(500, n_b=32, cap=400, seed=(9, 2))
    for _ in range(3):
        assert a.next_epoch() == b.next_epoch()
        got = np.concatenate([a.draw(k) for k in chunks])
        np.testing.assert_array_equal(got, b.draw(sum(chunks)))
    assert a.state()["drawn"] == b.state()["drawn"]
    assert a.state()["ei"] == b.state()["ei"]


def test_sampler_state_resumes_like_reference():
    a = tsam.AdaptiveSampler(200, n_b=16, seed=4)
    b = jsam.AdaptiveSampler(200, n_b=16, seed=4)
    for s in (a, b):
        s.next_epoch()
        s.draw(16)
    assert a.state() == b.state()
    ra = tsam.AdaptiveSampler.from_state(200, a.state(), eps=0.05, delta=0.1,
                                         n_b=16)
    rb = jsam.AdaptiveSampler.from_state(200, b.state(), eps=0.05, delta=0.1,
                                         n_b=16)
    assert ra.next_epoch() == rb.next_epoch()
    np.testing.assert_array_equal(ra.draw(32), rb.draw(32))
    assert ra.cap == rb.cap


@pytest.mark.parametrize("budget", [None, 70])
def test_uniform_stream_matches_reference(budget):
    a = tsam.UniformSampler(300, eps=0.2, delta=0.1, n_b=32, budget=budget,
                            seed=1)
    b = jsam.UniformSampler(300, eps=0.2, delta=0.1, n_b=32, budget=budget,
                            seed=1)
    assert a.budget == b.budget
    for x, y in zip(a.batches(), b.batches(), strict=True):
        assert x.epoch == y.epoch and x.n_valid == y.n_valid
        np.testing.assert_array_equal(x.sources, y.sources)


# ------------------------------------------------------------ statistics
def _moments(seed, n=50, tau=40):
    """(S1, S2) of τ samples of normalized-scale δ ∈ [0, n-2], with a few
    hub vertices and many near-zero ones, as a power-law graph gives."""
    rng = np.random.default_rng(seed)
    scale = np.where(rng.random(n) < 0.1, n - 2.0, 1.0)
    x = rng.random((tau, n)) ** 3 * scale
    return x.sum(0), (x * x).sum(0), tau


@pytest.mark.parametrize("n,eps,delta", [(10, 0.05, 0.1), (12536, 0.05, 0.1),
                                         (3342, 0.01, 0.01), (2, 0.3, 0.5)])
def test_hoeffding_budget_and_schedule(n, eps, delta):
    assert tsam.hoeffding_budget(n, eps, delta) == \
        jsam.hoeffding_budget(n, eps, delta)
    a, b = tsam.epoch_schedule(n % 17 + 1), jsam.epoch_schedule(n % 17 + 1)
    assert [next(a) for _ in range(12)] == [next(b) for _ in range(12)]


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("tau", [1, 2, 40])
def test_halfwidths_and_allocation_match_reference(seed, tau):
    s1, s2, _ = _moments(seed, tau=max(tau, 2))
    c = 48.0
    x1, x2 = s1 / c, s2 / (c * c)
    var = np.maximum(x2 / tau - (x1 / tau) ** 2, 0.0)
    for delta_v in (0.1 / 50, tsam.allocate_delta(var, 0.1)):
        for name in ("bernstein_halfwidth", "normal_halfwidth"):
            np.testing.assert_array_equal(
                getattr(tsam, name)(x1, x2, tau, delta_v),
                getattr(jsam, name)(x1, x2, tau, delta_v))
    np.testing.assert_array_equal(tsam.allocate_delta(var, 0.1),
                                  jsam.allocate_delta(var, 0.1))
    np.testing.assert_array_equal(tsam.allocate_delta(0 * var, 0.1),
                                  jsam.allocate_delta(0 * var, 0.1))


@pytest.mark.parametrize("rule", ["bernstein", "normal"])
@pytest.mark.parametrize("topk", [None, 3])
@pytest.mark.parametrize("eps", [0.02, 0.3])
def test_estimator_and_stopping_check_match_reference(rule, topk, eps):
    ours = tdrv.LambdaEstimator(50, eps, 0.1, rule)
    ref = jdrv.LambdaEstimator(50, eps, 0.1, rule)
    for i in range(3):  # three epochs of growing length
        s1, s2, tau = _moments(10 + i, tau=8 << i)
        ours.update(s1, s2, tau)
        ref.update(s1, s2, tau)
        stop, hw = tdrv.stopping_check(ours, eps, topk, i)
        rstop, rhw = jdrv.stopping_check(ref, eps, topk, i)
        assert stop == rstop
        np.testing.assert_array_equal(hw, rhw)
    assert ours.hw_history == ref.hw_history
    res, rres = (e.result(n_epochs=3, converged=False) for e in (ours, ref))
    np.testing.assert_array_equal(res.lam, rres.lam)
    np.testing.assert_array_equal(res.halfwidth, rres.halfwidth)
    np.testing.assert_array_equal(res.topk(5), rres.topk(5))
    assert res.topk_separated(3) == rres.topk_separated(3)
    assert ours.converged() == ref.converged()


def test_few_samples_never_converge_like_reference():
    for mod in (tdrv, jdrv):
        est = mod.LambdaEstimator(20, 0.9, 0.1, "normal")
        assert np.isinf(est.halfwidth_normalized()).all()
        est.update(np.ones(20), np.ones(20), 1)
        assert not est.converged()
        assert not mod.stopping_check(est, 0.9, None, 0)[0]


@pytest.mark.parametrize("n,m", [(54, 488), (3342, 97194), (12536, 425218)])
def test_sizing_helpers_match_reference(n, m):
    for backend in ("dense", "coo", "csr"):
        for p, tr in ((1, False), (4, True)):
            assert tdrv.adjacency_bytes(n, m, backend=backend, p=p,
                                        transpose=tr) == \
                jdrv.adjacency_bytes(n, m, backend=backend, p=p, transpose=tr)
    assert tdrv.state_bytes(n, 64, p=2) == jdrv.state_bytes(n, 64, p=2)
    for hint in (None, 20, 2487):
        for backend in ("dense", "coo"):
            assert tdrv.choose_sample_batch(n, m, backend=backend,
                                            budget_hint=hint) == \
                jdrv.choose_sample_batch(n, m, backend=backend,
                                         budget_hint=hint)


# ----------------------------------------------------------- batch steps
_GRAPHS = {"rmat6": lambda: rmat(6, 8, seed=5).remove_isolated()[0],
           "rmat5_w": lambda: rmat(5, 6, seed=2, weighted=True,
                                   max_weight=9).remove_isolated()[0],
           "er40_dir_w": lambda: erdos_renyi(40, 0.12, seed=11, weighted=True,
                                             max_weight=7, directed=True)}


def _pair(gname):
    g = _GRAPHS[gname]()
    ref = jax_dense_adj(g)
    return g, ref, dense_adj_from_arrays(np.asarray(ref.a), np.asarray(ref.at),
                                         device="cpu")


def _batch(g, nb, k, seed):
    rng = np.random.default_rng(seed)
    src = np.zeros(nb, np.int32)
    src[:k] = rng.integers(0, g.n, k)
    valid = np.arange(nb) < k
    return src, valid


def _close(ours, ref):
    s1, s2, nr = (x.numpy() for x in ours)
    r1, r2, rn = (np.asarray(x) for x in ref)
    np.testing.assert_allclose(s1, r1, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(s2, r2, rtol=1e-5, atol=1e-8)
    assert nr.dtype == np.int32
    np.testing.assert_array_equal(nr, rn)


@pytest.mark.parametrize("gname", sorted(_GRAPHS))
@pytest.mark.parametrize("nb,k", [(16, 16), (16, 11), (8, 1)])
def test_moments_step_matches_reference(gname, nb, k):
    g, ref, adj = _pair(gname)
    src, valid = _batch(g, nb, k, seed=nb + k)
    ours = metric_batch_moments(adj, torch.from_numpy(src),
                                torch.from_numpy(valid))
    _close(ours, jax_moments(ref, jnp.asarray(src), jnp.asarray(valid)))
    assert float(ours[0].abs().max()) > 0


@pytest.mark.parametrize("gname", sorted(_GRAPHS))
def test_segmented_step_matches_reference(gname):
    g, ref, adj = _pair(gname)
    src, valid = _batch(g, 16, 13, seed=3)
    sid = np.array([0, 0, 2, 1, 2, 2, 0, 1, 1, 1, 0, 2, 2, 3, 3, 3],
                   np.int32)  # rows 13-15 pad: the dump slot 3
    ours = metric_batch_moments_segmented(adj, torch.from_numpy(src),
                                          torch.from_numpy(valid), sid,
                                          n_slots=3)
    _close(ours, jax_segmented(ref, jnp.asarray(src), jnp.asarray(valid),
                               jnp.asarray(sid), n_slots=3))
    assert ours[0].shape == (3, g.n)


def test_segment_fold_is_each_slots_rows_in_order():
    """The fold equals a left-to-right loop over each slot's rows, bitwise,
    and drops the dump slot."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((23, 3, 17)).astype(np.float32)
                         * 1e3)
    sid = rng.integers(0, 5, 23).astype(np.int32)  # slot 4 = dump
    out = segment_fold(x, sid, 4)
    assert out.shape == (4, 3, 17)
    for j in range(4):
        acc = torch.zeros(3, 17)
        for r in np.flatnonzero(sid == j):
            acc = acc + x[r]
        assert torch.equal(out[j], acc)
    assert torch.equal(segment_fold(x[:0], sid[:0], 2), torch.zeros(2, 3, 17))
    for bad in (sid[:5], np.where(sid == 4, 5, sid), sid - 1):
        with pytest.raises(ValueError, match="slot_ids"):
            segment_fold(x, bad, 4)
