"""The port's COO and CSR backends against the JAX package (CPU only).

Both packages get the same seeded numpy inputs: graphs from the byte-equal
generators, the reference containers' own arc arrays (carried across with
``coo_adj_from_arrays`` / ``csr_adj_from_arrays``), and frontiers made
with numpy.

* CPU ``index_add_``, the tie sums of the sparse relax's plain version,
  adds in index order, as ``jax.ops.segment_sum`` does on the CPU: so the COO and
  CSR relaxes give ``w``, ``m``, ``p``, ``c`` and the child counts bitwise
  equal to the reference's, with non-integer ``m`` and ``p`` whose sums
  would change in the last bits in another order.
* ``mfbf``/``mfbr`` with ``trace=True``: ``SweepTrace`` fields equal the
  reference's; ``occupancy_summary`` equals the reference executor's
  in the accumulated counts it keeps.
* CSR against dense and COO: ``Tw``, ``Tm``, the child counts and
  ``n_reach`` bitwise, ``S1``/``S2`` within rtol 1e-5; the forced ladders
  ``((1, 1),)`` and ``((1, 2), (4, 8), (16, 64))`` and padding arcs
  bitwise equal to the default build.
* An unpinned ``solve`` (the planner picks CSR) against ``brandes_bc`` at
  rtol 1e-5, atol 1e-8; ``launch.calibrate`` writes the port's file, read
  back through ``$REPRO_TORCH_BC_CALIBRATION``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.bc as jbc
import repro.core.adjacency as jadj
import repro.core.monoids as jmono
from repro.core.mfbc import mfbc_batch_moments as jax_moments
from repro.core.mfbc import mfbc_batch_moments_traced as jax_traced
from repro.core.mfbf import mfbf as jax_mfbf
from repro.core.mfbr import mfbr as jax_mfbr
import repro_torch.bc as tbc
import repro_torch.core.adjacency as tadj
import repro_torch.core.monoids as tmono
from repro_torch.core.brandes_ref import brandes_bc
from repro_torch.core.mfbc import mfbc_batch_moments, mfbc_batch_moments_traced
from repro_torch.core.mfbf import TRACE_CAP, mfbf
from repro_torch.core.mfbr import mfbr
from repro_torch.graphs.generators import rmat
from repro_torch.kernels.ref import segment_sum_ref
from repro_torch.launch import bc_run, calibrate
from repro_torch.spgemm import cost_model as tcost

INF = np.inf
LADDERS = (((1, 1),), ((1, 2), (4, 8), (16, 64)))
_CACHE = {}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: these graphs are tiny, and the suite runs
    several workers at once, whose thread pools would contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _graph(scale=6, weighted=True, directed=False):
    key = (scale, weighted, directed)
    if key not in _CACHE:
        _CACHE[key] = rmat(scale, 8, seed=5, weighted=weighted, max_weight=3,
                           directed=directed).remove_isolated()[0]
    return _CACHE[key]


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.from_numpy(np.array(x))  # a writable copy


def _sources(g, nb, seed):
    return np.random.default_rng(seed).integers(0, g.n, nb).astype(np.int32)


def _frontier(n, nb, seed, *, off):
    """A (w, x) frontier: integer weights on half the entries (ties), and
    non-integer values whose sums depend on their order."""
    rng = np.random.default_rng(seed)
    active = rng.random((nb, n)) < 0.5
    w = np.where(active, rng.integers(0, 6, (nb, n)), off).astype(np.float32)
    x = np.where(active, rng.random((nb, n)) * 3 + 0.1, 0).astype(np.float32)
    return w, x


def _ref_coo(g):
    return jadj.coo_adj_from_graph(g)


def _ref_csr(g, **kw):
    return jadj.csr_adj_from_graph(g, **kw)


def _csr_pair(g, **kw):
    r = _ref_csr(g, **kw)
    ours = tadj.csr_adj_from_arrays(
        *(_np(x) for x in (r.indptr, r.src, r.dst, r.w, r.indptr_in,
                           r.src_in, r.w_in)), n=r.n, caps=r.caps,
        device="cpu")
    return r, ours


def _coo_pair(g):
    r = _ref_coo(g)
    return r, tadj.coo_adj_from_arrays(_np(r.src), _np(r.dst), _np(r.w), r.n,
                                       device="cpu")


def _eq(a, b, what=""):
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b), err_msg=what)


def _check_moments(got, want):
    """(S1, S2) within rtol 1e-5 (the sum over the batch's rows is taken
    in another order by XLA), n_reach bitwise."""
    for a, b in zip(got[:2], want[:2]):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-8)
    _eq(got[2], want[2])


# ------------------------------------------------------ the ordered sum
def test_cpu_index_add_is_the_ordered_sum():
    """The plain version's premise: CPU ``index_add_`` adds each segment's
    terms one at a time in index order, from 0 (as a float32 Python loop
    does), which is also what ``jax.ops.segment_sum`` gives on the CPU."""
    rng = np.random.default_rng(0)
    n, L, nb = 7, 400, 3
    seg = rng.integers(0, n, L)
    x = (rng.random((nb, L)) * 1e4 + 1e-3).astype(np.float32)
    loop = np.zeros((nb, n), np.float32)
    for s in range(nb):
        for e in range(L):
            loop[s, seg[e]] = np.float32(loop[s, seg[e]] + x[s, e])
    got = torch.zeros(nb, n).index_add_(1, _t(seg), _t(x)).numpy()
    _eq(got, loop)
    _eq(got, jax.ops.segment_sum(jnp.asarray(x).T, jnp.asarray(seg),
                                 num_segments=n).T)
    # a reordering of the terms changes the bits: the order is observable
    perm = rng.permutation(L)
    other = torch.zeros(nb, n).index_add_(1, _t(seg[perm]),
                                          _t(x[:, perm])).numpy()
    assert not np.array_equal(other, loop)


@pytest.mark.parametrize("count", [False, True])
def test_segment_sum_plain_version(count):
    """``segment_sum_ref``, the plain relax's tie sums: ties of finite
    ``best`` summed in arc order, empty and non-finite segments 0, dump
    arcs ignored."""
    rng = np.random.default_rng(1)
    n, nb = 9, 4
    seg = np.sort(rng.integers(0, n + 1, 120))  # n = the dump segment
    cand = rng.integers(0, 4, (nb, 120)).astype(np.float32)
    cand[:, ::7] = INF
    val = (rng.random((nb, 120)) + 0.5).astype(np.float32)
    best = rng.integers(0, 3, (nb, n)).astype(np.float32)
    best[1] = INF  # a row with no tie
    best[2, :3] = -INF
    runs = tmono.arc_runs(_t(seg), _t(np.arange(120)), _t(val[0]), n)
    _eq(runs.seg, seg)
    out, cnt = segment_sum_ref(_t(cand), _t(best), _t(val), runs.seg,
                               count=count)
    want = np.zeros((nb, n), np.float32)
    want_c = np.zeros((nb, n), np.float32)
    for s in range(nb):
        for e in range(120):
            v = seg[e]
            if v < n and np.isfinite(best[s, v]) and cand[s, e] == best[s, v]:
                want[s, v] = np.float32(want[s, v] + val[s, e])
                want_c[s, v] += 1
    _eq(out, want)
    if count:
        _eq(cnt, want_c)
    else:
        assert cnt is None
    assert not out[1].any() and not out[2, :3].any()


# ------------------------------------------------------- relaxations
@pytest.mark.parametrize("directed", [False, True])
@pytest.mark.parametrize("seed", [0, 1])
def test_coo_relaxes_match_reference_bitwise(directed, seed):
    g = _graph(6, directed=directed)
    r, ours = _coo_pair(g)
    nb = 5
    fw, fm = _frontier(g.n, nb, seed, off=INF)
    jm = jmono.multpath_relax_coo(jmono.Multpath(jnp.asarray(fw),
                                                 jnp.asarray(fm)),
                                  r.src, r.dst, r.w, r.n)
    tm = ours.relax_mp(tmono.Multpath(_t(fw), _t(fm)))
    _eq(tm.w, jm.w, "w")
    _eq(tm.m, jm.m, "m")
    cw, cp = _frontier(g.n, nb, seed + 10, off=-INF)
    F = jmono.Centpath(jnp.asarray(cw), jnp.asarray(cp),
                       jnp.asarray(np.isfinite(cw).astype(np.float32)))
    jc = jmono.centpath_relax_coo(F, r.src, r.dst, r.w, r.n)
    tc = ours.relax_cp(tmono.Centpath(_t(cw), _t(cp), None))
    for f in ("w", "p", "c"):
        _eq(getattr(tc, f), getattr(jc, f), f)
    # the arcs grouped here, not by the container: the same result
    again = tmono.multpath_relax_coo(tmono.Multpath(_t(fw), _t(fm)),
                                     ours.src, ours.dst, ours.w, ours.n)
    _eq(again.m, tm.m)
    # child counts against the reference, from real distances
    src = _sources(g, nb, seed)
    Tw, _ = jax_mfbf(r, jnp.asarray(src))
    _eq(ours.count_sp_children(_t(_np(Tw))), r.count_sp_children(Tw))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_csr_relaxes_match_reference_bitwise(seed):
    """Each rung that fits (and the fallback) against the reference's
    relax of the same rung."""
    g = _graph(6)
    r, ours = _csr_pair(g, n_b=8)
    nb = 4
    fw, fm = _frontier(g.n, nb, seed, off=INF)
    fw[:, ::2] = INF  # leave some columns inactive in every row
    fm[:, ::2] = 0
    cw, cp = _frontier(g.n, nb, seed + 5, off=-INF)
    cw[:, 1::3] = -INF
    cp[:, 1::3] = 0
    Fm = jmono.Multpath(jnp.asarray(fw), jnp.asarray(fm))
    Fc = jmono.Centpath(jnp.asarray(cw), jnp.asarray(cp),
                        jnp.asarray(np.isfinite(cw).astype(np.float32)))
    cap = (g.n, int(r.src.shape[0]))
    jm = jmono.multpath_relax_csr(Fm, r.indptr, r.dst, r.w, r.n,
                                  vcap=cap[0], ecap=cap[1])
    tm = tmono.multpath_relax_csr(tmono.Multpath(_t(fw), _t(fm)),
                                  ours.indptr, ours.dst, ours.w, ours.n,
                                  vcap=cap[0], ecap=cap[1])
    _eq(tm.w, jm.w, "w")
    _eq(tm.m, jm.m, "m")
    jc = jmono.centpath_relax_csr(Fc, r.indptr_in, r.src_in, r.w_in, r.n,
                                  vcap=cap[0], ecap=cap[1])
    tc = tmono.centpath_relax_csr(tmono.Centpath(_t(cw), _t(cp), None),
                                  ours.indptr_in, ours.src_in, ours.w_in,
                                  ours.n, vcap=cap[0], ecap=cap[1])
    for f in ("w", "p", "c"):
        _eq(getattr(tc, f), getattr(jc, f), f)
    # the container's own bucket pick (and the fallback) give the same
    got_m, st_m = ours.relax_mp_stats(tmono.Multpath(_t(fw), _t(fm)))
    jm2, jst = r.relax_mp_stats(Fm)
    _eq(got_m.m, jm2.m)
    assert (st_m.nnz, st_m.arcs, st_m.bucket, st_m.overflow) == \
        tuple(int(x) for x in jst)
    got_c, st_c = ours.relax_cp_stats(tmono.Centpath(_t(cw), _t(cp), None))
    jc2, jst = r.relax_cp_stats(Fc)
    _eq(got_c.p, jc2.p)
    assert tuple(st_c) == tuple(int(x) for x in jst)


@pytest.mark.parametrize("vcap,ecap", [(5, 16), (40, 64), (64, 1024)])
def test_compaction_matches_reference(vcap, ecap):
    g = _graph(6)
    r, ours = _csr_pair(g)
    mask = np.random.default_rng(vcap).random((3, g.n)) < 0.05
    ju, joffs = jmono._compact_cols(jnp.asarray(mask), r.indptr, vcap)
    tu, toffs = tmono._compact_cols(_t(mask), ours.indptr, vcap)
    _eq(tu, ju)
    _eq(toffs, joffs)
    jj, jeid, jlive = jmono._expand_edges(ju, joffs, r.indptr, ecap)
    tj, teid, tlive = tmono._expand_edges(tu, toffs, ours.indptr, ecap)
    _eq(tlive, jlive)
    _eq(teid, jeid)
    _eq(tj[tlive], _np(jj)[_np(jlive)])


def test_gather_rows_matches_reference():
    g = _graph(6)
    r, ours = _csr_pair(g)
    src = np.array([3, 0, 3, g.n - 1, 7], np.int32)  # a duplicate source
    _eq(ours.gather_rows(_t(src)), r.gather_rows(jnp.asarray(src)))
    rc, oc = _coo_pair(g)
    _eq(oc.gather_rows(_t(src)), rc.gather_rows(jnp.asarray(src)))


def test_containers_match_reference_arrays():
    g = _graph(6)
    r = _ref_csr(g, n_b=16)
    ours = tadj.csr_adj_from_graph(g, n_b=16, device="cpu")
    for f in ("indptr", "src", "dst", "w", "indptr_in", "src_in", "w_in"):
        _eq(getattr(ours, f), getattr(r, f), f)
    assert ours.caps == r.caps
    for nb, n, m in ((16, 100, 5000), (64, 174000, 7610770), (4, 3, 2)):
        assert tadj.frontier_caps(nb, n, m) == jadj.frontier_caps(nb, n, m)
    rc = _ref_coo(g)
    oc = tadj.coo_adj_from_graph(g, device="cpu")
    for f in ("src", "dst", "w"):
        _eq(getattr(oc, f), getattr(rc, f), f)


# ------------------------------------------------------ traced sweeps
@pytest.mark.parametrize("caps", [None] + list(LADDERS),
                         ids=["default", "tiny", "ladder"])
def test_traced_sweeps_match_reference(caps):
    g = _graph(7)
    kw = dict(n_b=8) if caps is None else dict(caps=caps)
    r, ours = _csr_pair(g, **kw)
    src = _sources(g, 8, 3)
    Tw, Tm, tr = mfbf(ours, _t(src), trace=True)
    jTw, jTm, jtr = jax.jit(lambda a, s: jax_mfbf(a, s, trace=True))(
        r, jnp.asarray(src))
    _eq(Tw, jTw)
    _eq(Tm, jTm)
    assert len(tr.fnnz) == TRACE_CAP
    assert tuple(tr.fnnz) == tuple(int(x) for x in _np(jtr.fnnz))
    assert (tr.iters, tr.overflows, tr.compact_hits) == \
        (int(jtr.iters), int(jtr.overflows), int(jtr.compact_hits))
    rows = np.arange(8)
    jTw = jTw.at[rows, src].set(INF)
    jTm = jTm.at[rows, src].set(1.0)
    Zp, trb = mfbr(ours, _t(_np(jTw)), _t(_np(jTm)), trace=True)
    jZp, jtrb = jax.jit(lambda a, w, m: jax_mfbr(a, w, m, trace=True))(
        r, jTw, jTm)
    _eq(Zp, jZp)
    assert tuple(trb.fnnz) == tuple(int(x) for x in _np(jtrb.fnnz))
    assert (trb.iters, trb.overflows, trb.compact_hits) == \
        (int(jtrb.iters), int(jtrb.overflows), int(jtrb.compact_hits))
    # the untraced loop runs the same relaxations
    Tw2, Tm2 = mfbf(ours, _t(src))
    _eq(Tw2, Tw)
    _eq(Tm2, Tm)


def test_traced_moments_and_dense_trace_match_reference():
    g = _graph(6)
    r, ours = _csr_pair(g, n_b=8)
    src, val = _sources(g, 8, 4), np.ones(8, bool)
    got = mfbc_batch_moments_traced(ours, _t(src), _t(val))
    want = jax_traced(r, jnp.asarray(src), jnp.asarray(val))
    _check_moments(got[:3], want[:3])
    assert got[3].iters == int(want[3].iters)
    # a format without compaction traces no buckets
    d = tadj.dense_adj_from_graph(g, device="cpu")
    _, _, tr = mfbf(d, _t(src), trace=True)
    assert tr.overflows == tr.compact_hits == 0 and tr.iters > 0
    assert tr.fnnz[tr.iters:] == (-1,) * (TRACE_CAP - tr.iters)


def test_occupancy_summary_matches_reference():
    g = _graph(7)
    q = dict(mode="approx", n_b=16, eps=0.2, delta=0.1, max_samples=48)
    jq = jbc.BCQuery(execution=jbc.ExecutionConfig(backend="csr"), **q)
    tq = tbc.BCQuery(execution=tbc.ExecutionConfig(backend="csr"), **q)
    jpl = jbc.BCPlanner(calibration=None).plan(g, jq, n_devices=1)
    tpl = tbc.BCPlanner(calibration=None).plan(g, tq, n_devices=1)
    ref_res = jbc.solve(g, jq, plan=jpl)
    res = tbc.solve(g, tq, plan=tpl, device="cpu")
    assert res.plan is not tpl and res.plan.occupancy is not None
    # the port keeps the reference's accumulated counts, not its
    # last-batch profile (per_iter_*, fnnz_*, iters_*)
    assert set(res.plan.occupancy) == {"batches", "overflows",
                                       "compact_hits", "relax_calls",
                                       "hit_rate"}
    assert res.plan.occupancy == {k: ref_res.plan.occupancy[k]
                                  for k in res.plan.occupancy}
    np.testing.assert_allclose(res.lam, ref_res.lam, rtol=1e-5, atol=1e-8)
    assert tbc.BCPlan.from_json(res.plan.to_json()).occupancy == \
        res.plan.occupancy


# -------------------------------------------------- backends agree
def _batch(adj, src):
    """(Tw, Tm, child counts, S1, S2, n_reach) of one batch."""
    s, v = _t(src), torch.ones(src.size, dtype=torch.bool)
    Tw, Tm = mfbf(adj, s)
    Tw_m = Tw.clone()
    Tw_m[torch.arange(src.size), s.long()] = INF
    return (Tw, Tm, adj.count_sp_children(Tw_m),
            *mfbc_batch_moments(adj, s, v))


@pytest.mark.parametrize("scale,nb", [(6, 8), (7, 16)])
def test_csr_matches_dense_and_coo(scale, nb):
    g = _graph(scale)
    src = _sources(g, nb, scale)
    csr = _batch(tadj.csr_adj_from_graph(g, n_b=nb, device="cpu"), src)
    for other in (tadj.dense_adj_from_graph(g, device="cpu"),
                  tadj.coo_adj_from_graph(g, device="cpu")):
        got = _batch(other, src)
        for i in (0, 1, 2, 5):  # Tw, Tm, child counts, n_reach
            _eq(got[i], csr[i])
        for i in (3, 4):  # S1, S2
            np.testing.assert_allclose(got[i], csr[i], rtol=1e-5, atol=1e-8)
    # COO and CSR sum in the same arc order: bitwise
    coo = _batch(tadj.coo_adj_from_graph(g, device="cpu"), src)
    for a, b in zip(coo, csr):
        _eq(a, b)


@pytest.mark.parametrize("caps", LADDERS, ids=["tiny", "ladder"])
@pytest.mark.parametrize("seed", [0, 1])
def test_forced_ladders_bitwise_equal_default(caps, seed):
    g = _graph(6)
    src = _t(_sources(g, 4, seed))
    val = torch.ones(4, dtype=torch.bool)
    ref_out = mfbc_batch_moments(tadj.csr_adj_from_graph(g, n_b=4,
                                                         device="cpu"),
                                 src, val)
    got = mfbc_batch_moments(tadj.csr_adj_from_graph(g, caps=caps,
                                                     device="cpu"), src, val)
    for a, b in zip(ref_out, got):
        _eq(a, b)


def test_padding_arcs_inert():
    g = _graph(6)
    src = _t(_sources(g, 4, 9))
    val = torch.ones(4, dtype=torch.bool)
    raw = mfbc_batch_moments(tadj.csr_adj_from_graph(
        g, n_b=4, pad_multiple=1, device="cpu"), src, val)
    padded = mfbc_batch_moments(tadj.csr_adj_from_graph(
        g, n_b=4, pad_multiple=32, device="cpu"), src, val)
    coo = mfbc_batch_moments(tadj.coo_adj_from_graph(
        g, pad_multiple=256, device="cpu"), src, val)
    for a, b, c in zip(raw, padded, coo):
        _eq(a, b)
        _eq(a, c)


def test_moments_match_reference():
    """The whole batch step against the reference's CSR step on the same
    arcs."""
    g = _graph(7)
    r, ours = _csr_pair(g, n_b=16)
    src, val = _sources(g, 16, 2), np.ones(16, bool)
    val[-3:] = False
    got = mfbc_batch_moments(ours, _t(src), _t(val))
    want = jax_moments(r, jnp.asarray(src), jnp.asarray(val))
    _check_moments(got, want)


# ----------------------------------------------------- unpinned solve
def test_unpinned_solve_plans_csr_and_matches_brandes():
    g = _graph(8)
    planner = tbc.BCPlanner(calibration=None)
    pl = planner.plan(g, tbc.BCQuery(), device="cpu")
    assert pl.backend == "csr"
    res = tbc.solve(g, tbc.BCQuery(), planner=planner, device="cpu")
    assert res.plan.backend == "csr" and res.plan.occupancy["batches"] > 0
    np.testing.assert_allclose(res.lam, brandes_bc(g), rtol=1e-5, atol=1e-8)
    approx = tbc.solve(g, tbc.BCQuery(mode="approx", eps=0.2, delta=0.1),
                       planner=planner, device="cpu")
    assert approx.plan.backend == "csr" and approx.approx.n_samples > 0


def test_bc_run_default_backend_is_auto(capsys, monkeypatch, tmp_path):
    monkeypatch.setenv(tcost.CALIBRATION_ENV, str(tmp_path / "none.json"))
    lam = bc_run.main(["--scale", "6", "--device", "cpu", "--nb", "0",
                       "--verify"])
    out = capsys.readouterr().out
    assert "backend=csr" in out and "occupancy:" in out
    assert "verified against the Brandes oracle" in out
    assert lam.shape[0] > 0


# ---------------------------------------------------------- calibrate
def test_calibrate_writes_the_port_file(tmp_path, monkeypatch):
    path = tmp_path / "cal.json"
    monkeypatch.setenv(tcost.CALIBRATION_ENV, str(path))
    cal = calibrate.main(["--scale", "6", "--device", "cpu", "--reps", "1"])
    assert path.is_file() and set(cal.rates) == {"dense", "coo", "csr"}
    assert json.loads(path.read_text())["meta"]["device"] == "cpu"
    loaded = tcost.load_calibration()
    assert loaded is not None and loaded.rates == cal.rates
    g = _graph(6)
    pl = tbc.plan(g, tbc.BCQuery(mode="approx"), device="cpu")
    assert pl.regime["calibrated"] is True
    assert "csr_s" in pl.regime


@pytest.mark.parametrize("backend", ["coo", "csr"])
def test_fused_equals_alone_per_backend(backend):
    """The fused-parity property on the sparse executors (the reference's
    ``test_fused_equals_unfused_per_backend``): slot j of a fused
    ``step_segmented`` equals a one-slot run of exactly its rows, bitwise,
    though the fused batch's union frontier picks other CSR buckets."""
    g = _graph(7)
    ex = tbc.build_executor(g, tbc.BCPlanner(calibration=None).plan(
        g, tbc.BCQuery(mode="approx", n_b=16, execution=tbc.ExecutionConfig(
            backend=backend)), n_devices=1), device="cpu")
    src = _sources(g, 16, 3)
    sid = np.repeat(np.arange(2, dtype=np.int32), [5, 11])
    fused = ex.step_segmented(src, np.ones(16, bool), sid, 2)
    for slot in range(2):
        rows = src[sid == slot]
        alone = ex.step_segmented(rows, np.ones(rows.size, bool),
                                  np.zeros(rows.size, np.int32), 1)
        for x, y in zip(fused, alone):
            _eq(x[slot], y[0])
