"""The port's metric registry against the JAX package (CPU only).

Both packages get the same seeded numpy inputs: graphs from the byte-equal
generators and the reference containers' own arrays (carried across with
``dense_adj_from_arrays`` / ``coo_adj_from_arrays`` /
``csr_adj_from_arrays``).

* ``components_graph`` equals the reference's arc for arc;
  ``components_labels`` is bitwise the reference's and ``cc_ref``'s, on
  dense, COO and CSR.
* ``metric_batch_moments`` and ``metric_batch_moments_segmented`` for
  closeness, khop (hops 1–3) and a betweenness + closeness mix: ``n_reach``
  and khop's counts bitwise, closeness and betweenness within rtol 1e-5.
* ``solve`` answers every metric through every backend: khop and
  components bitwise equal to the reference and to the oracles, closeness
  within rtol 1e-5 of the reference.
* Mirrors of the ``tests/test_metrics.py`` tests that need no service, on
  the port (``repro_torch.bc``, on the CPU).
* ``launch.bc_run --metric ... --verify`` passes its oracle on the CPU.
"""
import numpy as np
import pytest
import torch

try:
    from hypothesis import given, settings, strategies as st
except ImportError:  # deterministic sweep, see tests/_hypothesis_fallback.py
    from _hypothesis_fallback import given, settings, strategies as st

import repro.bc as jbc
import repro.core.adjacency as jadj
import repro.core.metrics as jmet
from repro.core.mfbc import metric_batch_moments as jax_moments
from repro.core.mfbc import metric_batch_moments_segmented as jax_segmented
from repro.graphs.generators import rmat as jax_rmat
import repro_torch.core.adjacency as tadj
from repro_torch.bc import (BatchAssembler, BCQuery, ExecutionConfig,
                            build_executor, fuse_group, metric_spec, plan,
                            registered_metrics, solve)
from repro_torch.core.brandes_ref import cc_ref, closeness_ref, khop_ref
from repro_torch.core.metrics import components_graph, components_labels
from repro_torch.core.mfbc import (metric_batch_moments,
                                   metric_batch_moments_segmented)
from repro_torch.graphs.generators import rmat
from repro_torch.launch import bc_run

BACKENDS = ("dense", "coo", "csr")
# name: (kinds, hops) of one batch body
BODIES = {"closeness": (("closeness",), 0), "khop1": (("khop",), 1),
          "khop2": (("khop",), 2), "khop3": (("khop",), 3),
          "bc+closeness": (("betweenness", "closeness"), 0)}
_CACHE = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these graphs are tiny, and the suite runs
    several workers at once, whose thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(weighted=False):
    """R-MAT scale 6, as ``tests/test_metrics.py``; weighted 1..9 too."""
    key = ("g", weighted)
    if key not in _CACHE:
        _CACHE[key] = rmat(6, 8, seed=5, weighted=weighted,
                           max_weight=9).remove_isolated()[0]
    return _CACHE[key]


def _split_graph():
    """Sparse R-MAT with isolated vertices kept: several weak components,
    singletons among them."""
    return rmat(7, 1, seed=2, weighted=True, max_weight=5)


def _np(x):
    return np.asarray(x)


def _pair(g, backend):
    """(reference adjacency, the port's on the CPU) over the same arrays."""
    if backend == "dense":
        r = jadj.dense_adj_from_graph(g)
        return r, tadj.dense_adj_from_arrays(_np(r.a), _np(r.at),
                                             device="cpu")
    if backend == "coo":
        r = jadj.coo_adj_from_graph(g)
        return r, tadj.coo_adj_from_arrays(_np(r.src), _np(r.dst), _np(r.w),
                                           r.n, device="cpu")
    r = jadj.csr_adj_from_graph(g, n_b=16)
    return r, tadj.csr_adj_from_arrays(
        *(_np(x) for x in (r.indptr, r.src, r.dst, r.w, r.indptr_in,
                           r.src_in, r.w_in)), n=r.n, caps=r.caps,
        device="cpu")


def _host_executor():
    if "host" not in _CACHE:
        g = _graph()
        _CACHE["host"] = build_executor(
            g, plan(g, BCQuery(mode="approx", n_b=64), n_devices=1,
                    device="cpu"), device="cpu")
    return _CACHE["host"]


# ----------------------------------------------------------- components
@pytest.mark.parametrize("backend", BACKENDS)
def test_components_labels_match_reference(backend):
    g = _split_graph()
    cg, jcg = components_graph(g), jmet.components_graph(g)
    for a, b in ((cg.src, jcg.src), (cg.dst, jcg.dst), (cg.w, jcg.w)):
        np.testing.assert_array_equal(a, b)
    assert cg.n == jcg.n and cg.name == jcg.name and not cg.directed
    r, ours = _pair(cg, backend)
    got = components_labels(ours).numpy()
    np.testing.assert_array_equal(got, _np(jmet.components_labels(r)))
    np.testing.assert_array_equal(got.astype(np.float64), cc_ref(g))
    assert len(np.unique(got)) > 2  # several components, singletons too


def test_components_csr_reads_once_per_iteration(monkeypatch):
    """On a CsrAdj the bucket counts ride the iteration's one read: the
    relax never reads them itself."""
    cg = components_graph(_split_graph())
    _, ours = _pair(cg, "csr")
    probes = []
    orig = ours.frontier_counts_mp
    monkeypatch.setattr(ours, "frontier_counts_mp",
                        lambda F: probes.append(1) or orig(F))
    relaxes = []
    orig_relax = ours.relax_mp_stats

    def relax(F, counts=None):
        assert counts is not None
        relaxes.append(1)
        return orig_relax(F, counts)

    monkeypatch.setattr(ours, "relax_mp_stats", relax)
    components_labels(ours)
    assert len(probes) == len(relaxes) + 1 and relaxes


# ---------------------------------------------------- metric batch bodies
def _batch(g, nb=16, seed=3):
    rng = np.random.default_rng(seed)
    src = rng.integers(0, g.n, nb).astype(np.int32)
    valid = rng.random(nb) < 0.85
    mids = (np.arange(nb) % 2).astype(np.int32)
    return src, valid, mids


def _check_moments(got, want, kinds):
    s1, s2, nr = (x.numpy() for x in got)
    if kinds == ("khop",):  # counts: integer-valued, exact
        np.testing.assert_array_equal(s1, _np(want[0]))
        np.testing.assert_array_equal(s2, _np(want[1]))
    else:
        np.testing.assert_allclose(s1, _np(want[0]), rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(s2, _np(want[1]), rtol=1e-5, atol=1e-6)
    np.testing.assert_array_equal(nr, _np(want[2]))


@pytest.mark.parametrize("body", sorted(BODIES))
@pytest.mark.parametrize("backend", BACKENDS)
def test_metric_batch_moments_match_reference(backend, body):
    kinds, hops = BODIES[body]
    g = _graph(weighted=True)
    r, ours = _pair(g, backend)
    src, valid, mids = _batch(g)
    mids = mids if len(kinds) > 1 else np.zeros_like(mids)
    got = metric_batch_moments(ours, torch.from_numpy(src),
                               torch.from_numpy(valid),
                               torch.from_numpy(mids), kinds=kinds, hops=hops)
    want = jax_moments(r, src, valid, mids, kinds=kinds, hops=hops)
    _check_moments(got, want, kinds)


@pytest.mark.parametrize("body", ["khop2", "bc+closeness"])
@pytest.mark.parametrize("backend", BACKENDS)
def test_metric_segmented_matches_reference(backend, body):
    kinds, hops = BODIES[body]
    g = _graph(weighted=True)
    r, ours = _pair(g, backend)
    src, valid, mids = _batch(g, seed=4)
    sid = np.array([0, 0, 1, 2, 1, 0, 3, 3, 2, 1, 0, 4, 4, 4, 4, 4],
                   np.int32)  # slot 4 = the dump segment of n_slots 4
    mids = mids if len(kinds) > 1 else np.zeros_like(mids)
    got = metric_batch_moments_segmented(
        ours, torch.from_numpy(src), torch.from_numpy(valid), sid,
        torch.from_numpy(mids), kinds=kinds, n_slots=4, hops=hops)
    want = jax_segmented(r, src, valid, sid, mids, kinds=kinds, n_slots=4,
                         hops=hops)
    _check_moments(got, want, kinds)


def test_metric_bodies_refuse_what_the_reference_refuses():
    g = _graph()
    _, ours = _pair(g, "dense")
    src, valid, mids = (torch.from_numpy(x) for x in _batch(g, nb=4))
    with pytest.raises(ValueError, match="cannot fuse"):
        metric_batch_moments(ours, src, valid, mids,
                             kinds=("khop", "closeness"), hops=2)
    with pytest.raises(ValueError, match="hops >= 1"):
        metric_batch_moments(ours, src, valid, mids, kinds=("khop",),
                             hops=0)
    with pytest.raises(ValueError, match="no sampled batch body"):
        metric_batch_moments(ours, src, valid, mids, kinds=("components",))


# ------------------------------------------------------ solve, end to end
_SOLVE_CASES = ["closeness", "khop:1", "khop:2", "khop:3", "components"]


@pytest.mark.parametrize("metric", _SOLVE_CASES)
@pytest.mark.parametrize("backend", BACKENDS)
def test_solve_matches_reference_and_oracle(backend, metric):
    name, _, hops = metric.partition(":")
    g = _graph(weighted=True)
    kw = dict(metric=name, hops=int(hops or 0), n_b=16)
    q = BCQuery(execution=ExecutionConfig(backend=backend), **kw)
    res = solve(g, q, device="cpu")
    jq = jbc.BCQuery(execution=jbc.ExecutionConfig(backend=backend), **kw)
    want = jbc.solve(g, jq, plan=jbc.plan(g, jq, n_devices=1)).lam
    assert res.plan.metric == name and res.n_swept == g.n
    if name == "closeness":
        np.testing.assert_allclose(res.lam, want, rtol=1e-5)
        np.testing.assert_allclose(res.lam, closeness_ref(g), rtol=1e-5)
    else:
        np.testing.assert_array_equal(res.lam, want)
        np.testing.assert_array_equal(
            res.lam, cc_ref(g) if name == "components"
            else khop_ref(g, hops=int(hops)))


def test_csr_metric_plans_pass_through_by_identity():
    """Metric batches take the untraced path, so even a CSR plan records
    no occupancy and comes back by identity."""
    g = _graph()
    csr = ExecutionConfig(backend="csr")
    for q in (BCQuery(metric="closeness", execution=csr),
              BCQuery(metric="khop", hops=2, execution=csr),
              BCQuery(metric="components", execution=csr)):
        pl = plan(g, q, n_devices=1, device="cpu")
        assert pl.backend == "csr"
        assert solve(g, q, plan=pl, device="cpu").plan is pl


def test_executor_labels_build_the_components_adjacency_once():
    ex = _host_executor()
    np.testing.assert_array_equal(ex.labels(), cc_ref(_graph()))
    adj = ex._cc_adj
    np.testing.assert_array_equal(ex.labels(), cc_ref(_graph()))
    assert ex._cc_adj is adj


# ------------------------- mirrors of tests/test_metrics.py (no service)
def test_registry_and_fuse_groups():
    names = registered_metrics()
    assert {"betweenness", "closeness", "khop", "components"} <= set(names)
    bc = metric_spec("betweenness")
    assert bc.sweeps == 2 and bc.needs_backward and bc.sampled
    cl = metric_spec("closeness")
    assert cl.sweeps == 1 and not cl.needs_backward and cl.sampled
    kh = metric_spec("khop")
    assert kh.bounded and kh.sampled
    cc = metric_spec("components")
    assert cc.fixed_point and not cc.sampled
    with pytest.raises(ValueError, match="registered"):
        metric_spec("nope")
    assert fuse_group("betweenness") == fuse_group("closeness")
    assert fuse_group("khop", 2) == fuse_group("khop", 2)
    assert fuse_group("khop", 2) != fuse_group("khop", 3)
    assert fuse_group("khop", 2) != fuse_group("betweenness")
    assert fuse_group("components") != fuse_group("closeness")
    assert registered_metrics() == jbc.registered_metrics()


def test_query_and_plan_metric_validation():
    with pytest.raises(ValueError, match="hops"):
        BCQuery(metric="khop")
    with pytest.raises(ValueError, match="hops"):
        BCQuery(metric="closeness", hops=3)
    with pytest.raises(ValueError, match="fixed point"):
        BCQuery(mode="approx", metric="components")


def test_default_plan_json_has_no_metric_keys():
    g = _graph()
    d = plan(g, BCQuery(mode="approx"), n_devices=1, device="cpu").to_json()
    assert "metric" not in d and "hops" not in d
    d = plan(g, BCQuery(mode="approx", metric="closeness"), n_devices=1,
             device="cpu").to_json()
    assert d["metric"] == "closeness" and "hops" not in d
    d = plan(g, BCQuery(mode="approx", metric="khop", hops=3), n_devices=1,
             device="cpu").to_json()
    assert d["metric"] == "khop" and d["hops"] == 3


def test_forward_only_metrics_price_one_sweep():
    g = _graph()
    pb = plan(g, BCQuery(mode="approx", n_b=32), n_devices=1, device="cpu")
    pc = plan(g, BCQuery(mode="approx", n_b=32, metric="closeness"),
              n_devices=1, device="cpu")
    assert pc.predicted_comm_bytes * 2 == pb.predicted_comm_bytes
    assert pc.predicted_seconds < pb.predicted_seconds


@st.composite
def _rmat_cases(draw):
    scale = draw(st.integers(min_value=3, max_value=5))
    degree = draw(st.integers(min_value=2, max_value=8))
    seed = draw(st.integers(min_value=0, max_value=2 ** 31 - 1))
    metric = draw(st.sampled_from(
        ["closeness", "khop:1", "khop:2", "khop:3", "components"]))
    return scale, degree, seed, metric


@settings(max_examples=10, deadline=None)
@given(_rmat_cases())
def test_metric_parity_on_random_rmat_all_backends(case):
    scale, degree, seed, metric = case
    g = rmat(scale, degree, seed=seed)
    jg = jax_rmat(scale, degree, seed=seed)
    np.testing.assert_array_equal(g.src, jg.src)  # byte-equal generators
    name, _, hops = metric.partition(":")
    if name == "closeness":
        ref, exact = closeness_ref(g), False
    elif name == "khop":
        ref, exact = khop_ref(g, hops=int(hops or 0)), True
    else:
        ref, exact = cc_ref(g), True
    for backend in BACKENDS:
        q = BCQuery(mode="exact", metric=name, hops=int(hops or 0),
                    execution=ExecutionConfig(backend=backend))
        lam = solve(g, q, plan=plan(g, q, n_devices=1, device="cpu"),
                    device="cpu").lam
        if exact:
            np.testing.assert_array_equal(lam, ref, err_msg=backend)
        else:
            np.testing.assert_allclose(lam, ref, rtol=1e-4, atol=1e-5,
                                       err_msg=backend)


def test_components_labels_bitwise_union_find():
    g = _graph()
    ref = cc_ref(g)
    for backend in BACKENDS:
        q = BCQuery(mode="exact", metric="components",
                    execution=ExecutionConfig(backend=backend))
        res = solve(g, q, plan=plan(g, q, n_devices=1, device="cpu"),
                    device="cpu")
        np.testing.assert_array_equal(res.lam, ref, err_msg=backend)
        assert res.converged and res.n_swept == g.n


def test_approx_closeness_converges_to_reference():
    g = _graph()
    res = solve(g, BCQuery(mode="approx", metric="closeness", eps=0.02,
                           delta=0.1, seed=7), device="cpu")
    assert res.approx is not None and res.converged
    ref = closeness_ref(g)
    assert set(res.topk(3)) <= set(np.argsort(ref)[::-1][:8])


def test_single_metric_segmented_matches_legacy_dispatch():
    ex = _host_executor()
    n = _graph().n
    rng = np.random.default_rng(3)
    src = rng.integers(0, n, 24).astype(np.int32)
    sid = np.sort(rng.integers(0, 3, 24).astype(np.int32))
    valid = np.ones(24, bool)
    legacy = ex.step_segmented(src, valid, sid, 3)
    tagged = ex.step_segmented(src, valid, sid, 3,
                               metrics=("betweenness",) * 3)
    for a, b in zip(legacy, tagged):
        np.testing.assert_array_equal(a, b)


@settings(max_examples=8, deadline=None)
@given(st.lists(st.tuples(st.sampled_from(["betweenness", "closeness"]),
                          st.integers(min_value=1, max_value=40)),
                min_size=1, max_size=5),
       st.integers(min_value=0, max_value=2 ** 16))
def test_cross_metric_fused_bitwise_equals_sequential(slots, seed):
    ex = _host_executor()
    n = _graph().n
    rng = np.random.default_rng(seed)
    demand = [(j, rng.integers(0, n, ln).astype(np.int32))
              for j, (_, ln) in enumerate(slots)]
    metric_of = {j: m for j, (m, _) in enumerate(slots)}
    for fb in BatchAssembler(ex).assemble(demand):
        metrics = tuple(metric_of[key] for key in fb.slots)
        s1, s2, nr = ex.step_segmented(fb.sources, fb.valid, fb.slot_ids,
                                       fb.n_slots, metrics=metrics)
        for j, key in enumerate(fb.slots):
            rows = fb.sources[(fb.slot_ids == j) & fb.valid]
            b1, b2, bn = ex.step_segmented(
                rows, np.ones(rows.shape[0], bool),
                np.zeros(rows.shape[0], np.int32), 1,
                metrics=(metric_of[key],))
            np.testing.assert_array_equal(s1[j], b1[0])
            np.testing.assert_array_equal(s2[j], b2[0])
            np.testing.assert_array_equal(nr[j], bn[0])


def test_khop_fused_group_bitwise():
    ex = _host_executor()
    n = _graph().n
    rng = np.random.default_rng(11)
    demand = [(0, rng.integers(0, n, 9).astype(np.int32)),
              (1, rng.integers(0, n, 13).astype(np.int32))]
    for fb in BatchAssembler(ex).assemble(demand):
        s1, s2, nr = ex.step_segmented(fb.sources, fb.valid, fb.slot_ids,
                                       fb.n_slots,
                                       metrics=("khop",) * fb.n_slots,
                                       hops=2)
        for j, key in enumerate(fb.slots):
            rows = fb.sources[(fb.slot_ids == j) & fb.valid]
            b1, _, _ = ex.step_segmented(
                rows, np.ones(rows.shape[0], bool),
                np.zeros(rows.shape[0], np.int32), 1,
                metrics=("khop",), hops=2)
            np.testing.assert_array_equal(s1[j], b1[0])


@pytest.mark.parametrize("backend", ["coo", "csr"])
def test_cross_metric_fused_bitwise_on_sparse_backends(backend):
    """The fused == alone guarantee on the sparse backends too, and a
    mixed khop + closeness batch raises."""
    g = _graph(weighted=True)
    ex = build_executor(g, plan(g, BCQuery(
        mode="approx", n_b=32, execution=ExecutionConfig(backend=backend)),
        n_devices=1, device="cpu"), device="cpu")
    rng = np.random.default_rng(17)
    demand = [(j, rng.integers(0, g.n, k).astype(np.int32))
              for j, k in enumerate((5, 11, 9))]
    metric_of = {0: "betweenness", 1: "closeness", 2: "closeness"}
    (fb,) = BatchAssembler(ex).assemble(demand)
    metrics = tuple(metric_of[key] for key in fb.slots)
    fused = ex.step_segmented(fb.sources, fb.valid, fb.slot_ids, fb.n_slots,
                              metrics=metrics)
    for j, key in enumerate(fb.slots):
        rows = demand[key][1]
        alone = ex.step_segmented(rows, np.ones(rows.size, bool),
                                  np.zeros(rows.size, np.int32), 1,
                                  metrics=(metric_of[key],))
        for x, y in zip(fused, alone):
            np.testing.assert_array_equal(x[j], y[0])
    with pytest.raises(ValueError, match="cannot fuse"):
        ex.step_segmented(fb.sources, fb.valid, fb.slot_ids, fb.n_slots,
                          metrics=("khop",) + metrics[1:], hops=2)


# ------------------------------------------------------------------- CLI
@pytest.mark.parametrize("argv,expect", [
    (["--metric", "closeness"], "verified against closeness_ref oracle"),
    (["--metric", "khop", "--hops", "2", "--backend", "coo"],
     "verified against khop_ref oracle"),
    (["--metric", "components", "--backend", "dense"],
     "verified against cc_ref oracle"),
    (["--metric", "khop", "--hops", "1", "--approx", "0.1,0.1"],
     "vs khop_ref oracle: top-10 precision"),
])
def test_bc_run_metric_verifies_on_cpu(argv, expect, capsys):
    out = bc_run.main(["--scale", "5", "--device", "cpu", "--verify"]
                      + argv)
    assert expect in capsys.readouterr().out
    assert np.all(np.isfinite(getattr(out, "lam", out)))


def test_bc_run_metric_refuses_a_bad_query():
    with pytest.raises(SystemExit, match="hops"):
        bc_run.main(["--scale", "3", "--device", "cpu", "--metric", "khop"])
    with pytest.raises(SystemExit, match="fixed point"):
        bc_run.main(["--scale", "3", "--device", "cpu", "--metric",
                     "components", "--approx", "0.1,0.1"])
