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
* ``CsrAdj``'s bucket hits and overflows after ``mfbf``/``mfbr`` equal
  the reference's ``SweepTrace`` counts; ``occupancy_summary`` equals the
  reference executor's in the accumulated counts it keeps, and grows on
  betweenness ``step``/``step_sum`` only.
* CSR against dense and COO: ``Tw``, ``Tm``, the child counts and
  ``n_reach`` bitwise, ``S1``/``S2`` within rtol 1e-5; the forced ladders
  ``((1, 1),)`` and ``((1, 2), (4, 8), (16, 64))`` and padding arcs
  bitwise equal to the default build.
* ``csr_runs`` over the frontier's live arcs alone against the full
  ``ecap`` expansion: the same ``offsets`` and runs, the relaxes bitwise
  the reference's (an empty frontier, ``arcs == ecap``, degree-0 columns,
  padding arcs, a hub range longer than the kernel's tile).
* An unpinned ``solve`` (the planner picks CSR) against ``brandes_bc`` at
  rtol 1e-5, atol 1e-8; ``launch.calibrate`` writes the port's file, read
  back through ``$REPRO_TORCH_BC_CALIBRATION``.
"""
import dataclasses
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
from repro_torch.core.mfbc import mfbc_batch, metric_batch_moments
from repro_torch.core.mfbf import mfbf
from repro_torch.core.mfbr import mfbr
from repro_torch.graphs.generators import rmat, star_graph
from repro_torch.kernels.csr_expand import csr_expand_cuda
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
    # the frontier's live arcs, as CsrAdj reads them to pick the bucket
    _, arcs_m = ours.frontier_counts_mp(
        tmono.Multpath(_t(fw), _t(fm))).tolist()
    _, arcs_c = ours.frontier_counts_cp(
        tmono.Centpath(_t(cw), _t(cp), None)).tolist()
    assert 0 < arcs_m < cap[1] and 0 < arcs_c < cap[1]
    jm = jmono.multpath_relax_csr(Fm, r.indptr, r.dst, r.w, r.n,
                                  vcap=cap[0], ecap=cap[1])
    tm = tmono.multpath_relax_csr(tmono.Multpath(_t(fw), _t(fm)),
                                  ours.indptr, ours.dst, ours.w, ours.n,
                                  vcap=cap[0], ecap=cap[1], arcs=arcs_m)
    _eq(tm.w, jm.w, "w")
    _eq(tm.m, jm.m, "m")
    jc = jmono.centpath_relax_csr(Fc, r.indptr_in, r.src_in, r.w_in, r.n,
                                  vcap=cap[0], ecap=cap[1])
    tc = tmono.centpath_relax_csr(tmono.Centpath(_t(cw), _t(cp), None),
                                  ours.indptr_in, ours.src_in, ours.w_in,
                                  ours.n, vcap=cap[0], ecap=cap[1],
                                  arcs=arcs_c)
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


def _expansion_case(case):
    """(graph, pad_multiple, active columns) of one live-prefix case."""
    if case == "long":  # a hub range longer than the kernel's 2048-slot tile
        g = star_graph(3000, weighted=True, seed=3)
        return g, 1, np.array([0, 5, 17, 2999])
    g = _graph(6, directed=case == "degree0")
    rng = np.random.default_rng(len(case))
    cols = np.flatnonzero(rng.random(g.n) < 0.3)
    if case == "empty":
        cols = cols[:0]
    elif case == "degree0":  # columns with no arcs on either side
        none = np.flatnonzero((g.out_degrees() == 0)
                              | (np.bincount(g.dst, minlength=g.n) == 0))
        assert none.size > 0
        cols = np.union1d(cols, none)
    elif case == "padding":  # the padding arcs (w = inf) leave n - 1
        cols = np.union1d(cols, [g.n - 1])
    return g, 128 if case == "padding" else 1, cols


@pytest.mark.parametrize("side", ["mp", "cp"])
@pytest.mark.parametrize("case",
                         ["empty", "full", "degree0", "padding", "long"])
def test_live_prefix_runs_match_the_full_expansion(case, side):
    """``csr_runs`` given the frontier's arcs expands only those slots:
    its ``offsets`` and runs before ``offsets[n]`` equal the full ``ecap``
    expansion's, its tail holds the padding arcs alone, and the relaxes
    through it stay bitwise the reference's."""
    g, pad, cols = _expansion_case(case)
    r, ours = _csr_pair(g, pad_multiple=pad)
    nb = 3
    fw, fx = _frontier(g.n, nb, 7, off=INF if side == "mp" else -INF)
    inactive = np.ones(g.n, bool)
    inactive[cols] = False
    fw[:, inactive] = INF if side == "mp" else -INF
    fx[:, inactive] = 0
    fw[:, cols] = np.where(np.isfinite(fw[:, cols]), fw[:, cols], 1.0)
    fx[:, cols] = np.where(fx[:, cols] > 0, fx[:, cols], 0.5)
    if side == "mp":
        F = tmono.Multpath(_t(fw), _t(fx))
        nnz, arcs = ours.frontier_counts_mp(F).tolist()
        indptr, seg, w = ours.indptr, ours.dst, ours.w
    else:
        F = tmono.Centpath(_t(fw), _t(fx), None)
        nnz, arcs = ours.frontier_counts_cp(F).tolist()
        indptr, seg, w = ours.indptr_in, ours.src_in, ours.w_in
    assert nnz == cols.size and (arcs == 0) == (case == "empty")
    deg = (indptr[1:] - indptr[:-1]).numpy()
    assert (deg[cols] == 0).any() == (case == "degree0")
    vcap = g.n
    ecap = max(arcs, 1) if case == "full" else 2 * arcs + 64
    full = tmono.csr_runs(F.w, indptr, seg, w, g.n, vcap=vcap, ecap=ecap,
                          arcs=ecap)
    live = tmono.csr_runs(F.w, indptr, seg, w, g.n, vcap=vcap, ecap=ecap,
                          arcs=arcs)
    assert full.col.shape[0] == ecap and live.col.shape[0] == arcs
    _eq(live.offsets, full.offsets, "offsets")
    k = int(full.offsets[-1])
    for f in ("col", "seg", "w"):
        _eq(getattr(live, f)[:k], getattr(full, f)[:k], f)
    assert (live.seg[k:] == g.n).all() and torch.isinf(live.w[k:]).all()
    assert (k < arcs) == (case == "padding")
    if side == "mp":
        got = tmono.multpath_relax_csr(F, indptr, seg, w, g.n, vcap=vcap,
                                       ecap=ecap, arcs=arcs)
        want = jmono.multpath_relax_csr(
            jmono.Multpath(jnp.asarray(fw), jnp.asarray(fx)), r.indptr,
            r.dst, r.w, r.n, vcap=vcap, ecap=ecap)
    else:
        got = tmono.centpath_relax_csr(F, indptr, seg, w, g.n, vcap=vcap,
                                       ecap=ecap, arcs=arcs)
        want = jmono.centpath_relax_csr(
            jmono.Centpath(jnp.asarray(fw), jnp.asarray(fx),
                           jnp.asarray(np.isfinite(fw).astype(np.float32))),
            r.indptr_in, r.src_in, r.w_in, r.n, vcap=vcap, ecap=ecap)
    for f in got._fields:
        _eq(getattr(got, f), getattr(want, f), f)


def test_csr_expand_wrapper_refuses_cpu_tensors():
    """No quiet fallback: the expansion's wrapper raises before any launch
    on CPU tensors, and counts no launch."""
    before = csr_expand_cuda.launches
    idx = torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        csr_expand_cuda(idx, idx, idx, idx, torch.zeros(4), 3, 2)
    assert csr_expand_cuda.launches == before


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


# ------------------------------------------------------ occupancy counts
def _counts(adj):
    return adj.compact_hits, adj.overflows


def _grew(adj, before):
    """(relax calls, overflows, compact hits) since ``before``."""
    hits, over = (x - y for x, y in zip(_counts(adj), before))
    return hits + over, over, hits


def _trace_counts(tr):
    return int(tr.iters), int(tr.overflows), int(tr.compact_hits)


@pytest.mark.parametrize("caps", [None] + list(LADDERS),
                         ids=["default", "tiny", "ladder"])
def test_traced_sweeps_match_reference(caps):
    """The relaxes ``CsrAdj`` counts over each sweep are the reference's
    ``SweepTrace`` counts: one per iteration, a bucket hit or an overflow."""
    g = _graph(7)
    kw = dict(n_b=8) if caps is None else dict(caps=caps)
    r, ours = _csr_pair(g, **kw)
    src = _sources(g, 8, 3)
    Tw, Tm = mfbf(ours, _t(src))
    jTw, jTm, jtr = jax.jit(lambda a, s: jax_mfbf(a, s, trace=True))(
        r, jnp.asarray(src))
    _eq(Tw, jTw)
    _eq(Tm, jTm)
    assert _grew(ours, (0, 0)) == _trace_counts(jtr)
    rows = np.arange(8)
    jTw = jTw.at[rows, src].set(INF)
    jTm = jTm.at[rows, src].set(1.0)
    before = _counts(ours)
    Zp = mfbr(ours, _t(_np(jTw)), _t(_np(jTm)))
    jZp, jtrb = jax.jit(lambda a, w, m: jax_mfbr(a, w, m, trace=True))(
        r, jTw, jTm)
    _eq(Zp, jZp)
    assert _grew(ours, before) == _trace_counts(jtrb)
    # a fixed loop of as many iterations runs the same relaxations
    before = _counts(ours)
    Tw2, Tm2 = mfbf(ours, _t(src), iterate="fori", max_iters=int(jtr.iters))
    _eq(Tw2, Tw)
    _eq(Tm2, Tm)
    assert _grew(ours, before) == _trace_counts(jtr)


def test_traced_moments_and_dense_trace_match_reference():
    g = _graph(6)
    r, ours = _csr_pair(g, n_b=8)
    src, val = _sources(g, 8, 4), np.ones(8, bool)
    got = metric_batch_moments(ours, _t(src), _t(val))
    want = jax_traced(r, jnp.asarray(src), jnp.asarray(val))
    _check_moments(got, want[:3])
    assert _grew(ours, (0, 0)) == tuple(
        a + b for a, b in zip(_trace_counts(want[3]), _trace_counts(want[4])))
    # a format without compaction counts nothing
    q = tbc.BCQuery(mode="exact", n_b=8,
                    execution=tbc.ExecutionConfig(backend="dense"))
    ex = tbc.build_executor(g, tbc.plan(g, q, n_devices=1, device="cpu"),
                            device="cpu")
    dense = ex.step(src, val)
    ex.step_sum(src, val)
    assert ex.occupancy_summary() is None
    assert not hasattr(ex._adj, "compact_hits")
    _eq(dense[2], got[2])


@pytest.mark.parametrize("caps", [None, LADDERS[0]], ids=["default", "tiny"])
def test_executor_counts_betweenness_batches_only(caps):
    """Occupancy grows on betweenness ``step`` and ``step_sum``, not on
    ``step_segmented`` or a closeness batch; ``step_sum`` is
    ``mfbc_batch``'s λ_partial bitwise and ``step``'s S1 within rtol."""
    g = _graph(7)
    q = tbc.BCQuery(mode="exact", n_b=8,
                    execution=tbc.ExecutionConfig(backend="csr"))
    ex = tbc.build_executor(g, tbc.plan(g, q, n_devices=1, device="cpu"),
                            device="cpu")
    if caps is not None:
        ex._adj = dataclasses.replace(ex._adj, caps=caps)
    adj = ex._adj
    src, val = _sources(g, 8, 6), np.ones(8, bool)
    val[-2:] = False
    sid = np.array([0, 0, 1, 1, 0, 1, 0, 1], np.int32)
    ex.step_segmented(src, val, sid, 2)
    ex.step_segmented(src, val, sid, 2, metrics=("closeness", "betweenness"))
    ex.step(src, val, metric="closeness")
    ex.step_sum(src, val, metric="closeness")
    assert ex.occupancy_summary() is None
    assert sum(_counts(adj)) > 0  # the adjacency counted them all
    before = _counts(adj)
    lam = ex.step_sum(src, val)
    one = ex.occupancy_summary()
    calls, over, hits = _grew(adj, before)
    assert one == {"batches": 1, "overflows": over, "compact_hits": hits,
                   "relax_calls": calls, "hit_rate": hits / calls}
    assert calls > 0 and (hits == 0) == (caps is not None)
    s1, _, _ = ex.step(src, val)
    two = ex.occupancy_summary()
    assert two["batches"] == 2
    for k in ("overflows", "compact_hits", "relax_calls"):
        assert two[k] == 2 * one[k]
    want, _, _ = mfbc_batch(adj, _t(src), _t(val))
    _eq(lam, want.numpy().astype(np.float64))
    np.testing.assert_allclose(lam, s1, rtol=1e-5, atol=1e-8)


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
            *metric_batch_moments(adj, s, v))


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
    ref_out = metric_batch_moments(
        tadj.csr_adj_from_graph(g, n_b=4, device="cpu"), src, val)
    got = metric_batch_moments(
        tadj.csr_adj_from_graph(g, caps=caps, device="cpu"), src, val)
    for a, b in zip(ref_out, got):
        _eq(a, b)


def test_padding_arcs_inert():
    g = _graph(6)
    src = _t(_sources(g, 4, 9))
    val = torch.ones(4, dtype=torch.bool)
    raw = metric_batch_moments(tadj.csr_adj_from_graph(
        g, n_b=4, pad_multiple=1, device="cpu"), src, val)
    padded = metric_batch_moments(tadj.csr_adj_from_graph(
        g, n_b=4, pad_multiple=32, device="cpu"), src, val)
    coo = metric_batch_moments(tadj.coo_adj_from_graph(
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
    got = metric_batch_moments(ours, _t(src), _t(val))
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
