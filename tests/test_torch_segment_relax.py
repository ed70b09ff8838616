"""The sparse-relax kernel's schedule, emulated on the CPU, and the kernel.

``csrc/segment_relax.cu`` cannot run here, so ``emulate`` below writes out
its schedule in numpy float32: the binning of runs by length, short runs
walked by one lane per row with the monoid's online update, long runs cut
into rounds of ``CHUNK`` arcs and stripes of ``R`` arcs with the min/max
taken per stripe and then across stripes, and the ties flagged per
(stripe, row) as the bits of a word, the first ``TIE_SLOTS`` values kept,
and added stripe by stripe, bit by bit. It is held bitwise, in every
output field, to the plain version (``kernels.ref``) and to the reference's
``multpath_relax_coo`` / ``centpath_relax_coo`` (jax on the CPU), over runs
that cross the chunk and stripe boundaries, all-ties runs whose sums depend
on their order, empty runs, ±inf weights, a dead tail past ``offsets[n]``
and a row with no finite candidate.

The tests marked ``cuda`` hold the kernel against its plain version run on
the CPU, bitwise over two launches, and check that a sparse ``mfbc`` on the
card launches it; they skip on a host without a card, and need no jax. On
the card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_segment_relax.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core.monoids import arc_runs
from repro_torch.kernels import ref
from repro_torch.kernels.segment_relax import (LONG_RUN,
                                               centpath_segment_relax,
                                               multpath_segment_relax,
                                               segment_relax_cuda)

INF = np.float32(np.inf)
CHUNK = 256  # csrc/segment_relax.cu: THREADS, the arcs of a round
TIE_SLOTS = 4  # csrc/segment_relax.cu: tie values a long-run lane keeps
# name: (nb, run lengths, what the inputs stress)
CASES = {
    # runs across the 32-lane, stripe and 256-arc round boundaries
    "chunk_edges": (5, [31, 32, 33, 0, 4095, 0, 4097, 1, 2, 255, 256, 257]),
    # every candidate of a run ties, values 2**24 and 1.0 mixed: any other
    # order of the adds gives other bits; 40 rows take two row tiles
    "all_ties": (40, [3, 40, 300, 600, 0, 1, 70]),
    # +inf weights (padding arcs), -inf in MFBr, a short and a long run
    "inf_weights": (16, [7, 0, 513, 64, 2]),
    # one row, as the components sweep relaxes it: zero weights, so every
    # candidate of a run ties, in runs past LONG_RUN and short ones
    "zero_ties_nb1": (1, [700, 0, 3, 300, 1, 257]),
}
# on the card also a run as long as R-MAT scale 18's largest degree
CARD_CASES = {**CASES, "long_25231": (16, [25231] + list(range(40)))}


def _pow2_rows(nb):
    r = 1
    while r < nb and r < 32:
        r *= 2
    return r


def make_case(case, kind, seed=0):
    """numpy (fw, f2, seg, col, w, n) in arc order before grouping: arcs
    of segment n are dead (a tail past offsets[n] once grouped)."""
    nb, runs = CARD_CASES[case]
    rng = np.random.default_rng(seed)
    mp = kind == "mp"
    n = len(runs)
    seg = np.concatenate([np.repeat(np.arange(n), runs), np.full(9, n)])
    seg = seg[rng.permutation(seg.size)]  # grouping must keep arc order
    L = seg.size
    col = rng.integers(0, n, L)
    off = INF if mp else -INF
    if case in ("all_ties", "zero_ties_nb1"):
        fw = np.zeros((nb, n), np.float32)
        f2 = np.ones((nb, n), np.float32)
        f2[:, 0] = 2.0 ** 24  # 1 + 2**24 rounds back to 2**24
        w = np.full(L, 0.0 if case == "zero_ties_nb1" else 1.0, np.float32)
    else:
        active = rng.random((nb, n)) < 0.6
        fw = np.where(active, rng.integers(0, 6, (nb, n)), off)
        fw = fw.astype(np.float32)
        f2 = np.where(active, rng.random((nb, n)) * 3 + 0.1, 0)
        f2 = f2.astype(np.float32)
        w = rng.integers(1, 4, L).astype(np.float32)
        if case == "inf_weights":
            w[rng.random(L) < 0.2] = np.inf
            if not mp:
                w[rng.random(L) < 0.1] = -np.inf
    if nb > 1:
        fw[-1] = off  # a row with no finite candidate
        f2[-1] = 0
    return fw, f2, seg, col, w, n


def _runs(seg, col, w, n):
    return arc_runs(torch.from_numpy(seg), torch.from_numpy(col),
                    torch.from_numpy(w), n)


def emulate(kind, fw, f2, col, w, offsets, threshold):
    """The kernel's schedule in numpy float32 (``csrc/segment_relax.cu``).

    Returns (w, x) for MFBF and (w, x, c) for MFBr, each (nb, n)."""
    mp = kind == "mp"
    ident = INF if mp else -INF
    nb, n = fw.shape
    R = _pow2_rows(nb)
    S, T = CHUNK // R, R  # stripes of a round, arcs of a stripe
    G = np.stack([fw.T, f2.T], axis=-1)  # the prep pass: (n, nb, 2)
    L = col.size
    lo = np.clip(offsets[:-1], 0, L)
    hi = np.minimum(np.maximum(offsets[1:], lo), L)
    long_runs = {v for v in range(n) if hi[v] - lo[v] > threshold}
    out_w = np.empty((nb, n), np.float32)
    out_x = np.empty((nb, n), np.float32)
    out_c = np.empty((nb, n), np.float32)

    def gather(e, rows):
        c = col[e]
        if 0 <= c < n:
            return G[c, rows, 0], G[c, rows, 1]
        return np.full(rows.size, ident), np.zeros(rows.size, np.float32)

    def cand(x, we):
        if mp:
            return (x + we).astype(np.float32)
        ok = np.isfinite(x) & np.isfinite(we)
        with np.errstate(invalid="ignore"):
            return np.where(ok, x - we, -INF).astype(np.float32)

    def better(c, best):
        return c < best if mp else c > best

    def write(v, rows, best, acc, cnt):
        key = acc if mp else cnt
        out_w[rows, v] = np.where(key > 0, best, INF if mp else -INF)
        out_x[rows, v] = acc
        out_c[rows, v] = cnt

    for v in range(n):
        for s0 in range(0, nb, R):
            rows = np.arange(s0, min(s0 + R, nb))
            best = np.full(rows.size, ident, np.float32)
            acc = np.zeros(rows.size, np.float32)
            cnt = np.zeros(rows.size, np.float32)
            if v not in long_runs:
                # one lane per row, the run in arc order, online update
                for e in range(lo[v], hi[v]):
                    x, x2 = gather(e, rows)
                    cd = cand(x, w[e])
                    b = better(cd, best)
                    best = np.where(b, cd, best)
                    acc = np.where(b, np.float32(0), acc)
                    cnt = np.where(b, np.float32(0), cnt)
                    tie = (cd == best) & np.isfinite(cd)
                    acc = np.where(tie, acc + x2, acc)
                    cnt = np.where(tie, cnt + np.float32(1), cnt)
                write(v, rows, best, acc, cnt)
                continue
            rounds = range(lo[v], hi[v], CHUNK)
            # pass 1: each stripe's min/max over the rounds, then across
            part = np.full((S, rows.size), ident, np.float32)
            for b0 in rounds:
                for st in range(S):
                    for t in range(T):
                        e = b0 + st * T + t
                        if e < hi[v]:
                            cd = cand(gather(e, rows)[0], w[e])
                            part[st] = np.where(better(cd, part[st]), cd,
                                                part[st])
            for st in range(S):
                best = np.where(better(part[st], best), part[st], best)
            # pass 2: each (stripe, row) flags its ties as bits of one
            # word and keeps the first TIE_SLOTS values; a round with any
            # tie adds them stripe by stripe, bit by bit, loading again
            # the values past the kept ones
            for b0 in rounds:
                flags = np.zeros((S, rows.size), np.int64)
                kept = np.zeros((S, rows.size, TIE_SLOTS), np.float32)
                for st in range(S):
                    nt = np.zeros(rows.size, np.int64)
                    for t in range(T):
                        e = b0 + st * T + t
                        if e >= hi[v]:
                            continue
                        x, x2 = gather(e, rows)
                        cd = cand(x, w[e])
                        for i in np.flatnonzero((cd == best)
                                                & np.isfinite(cd)):
                            flags[st, i] |= 1 << t
                            if nt[i] < TIE_SLOTS:
                                kept[st, i, nt[i]] = x2[i]
                            nt[i] += 1
                if not flags.any():
                    continue
                for i in range(rows.size):
                    for st in range(S):
                        j = 0
                        for t in range(T):
                            if flags[st, i] >> t & 1:
                                val = (kept[st, i, j] if j < TIE_SLOTS else
                                       gather(b0 + st * T + t, rows)[1][i])
                                acc[i] = np.float32(acc[i] + val)
                                cnt[i] = np.float32(cnt[i] + 1)
                                j += 1
            write(v, rows, best, acc, cnt)
    return (out_w, out_x) if mp else (out_w, out_x, out_c)


def _plain(kind, fw, f2, r):
    t = torch.from_numpy
    fn = (ref.multpath_segment_relax_ref if kind == "mp"
          else ref.centpath_segment_relax_ref)
    return [x.numpy() for x in fn(t(fw), t(f2), r.col, r.seg, r.w)]


def _jax_relax(kind, fw, f2, seg, col, w, n):
    """The reference's relax of the live arcs (the dead ones reduce into
    no segment), in their order before grouping."""
    jax = pytest.importorskip("jax")
    import repro.core.monoids as jmono
    jnp = jax.numpy
    live = seg < n
    seg, col, w = seg[live], col[live], w[live]
    if kind == "mp":
        out = jmono.multpath_relax_coo(
            jmono.Multpath(jnp.asarray(fw), jnp.asarray(f2)),
            jnp.asarray(col), jnp.asarray(seg), jnp.asarray(w), n)
        return [np.asarray(out.w), np.asarray(out.m)]
    F = jmono.Centpath(jnp.asarray(fw), jnp.asarray(f2),
                       jnp.asarray(np.isfinite(fw).astype(np.float32)))
    out = jmono.centpath_relax_coo(F, jnp.asarray(seg), jnp.asarray(col),
                                   jnp.asarray(w), n)
    return [np.asarray(out.w), np.asarray(out.p), np.asarray(out.c)]


def _eq(got, want, what):
    for field, x, y in zip("wxc", got, want):
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {field}")


@pytest.mark.parametrize("threshold", [0, 32, LONG_RUN])
@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("kind", ["mp", "cp"])
def test_emulated_schedule_matches_plain_and_reference(kind, case, threshold):
    """threshold 0 sends every run down the long path, 32 splits the runs
    between the two, LONG_RUN is the wrapper's default."""
    fw, f2, seg, col, w, n = make_case(case, kind)
    r = _runs(seg, col, w, n)
    offsets = r.offsets.numpy()
    assert offsets[-1] < seg.size  # a dead tail lies past offsets[n]
    got = emulate(kind, fw, f2, r.col.numpy(), r.w.numpy(), offsets,
                  threshold)
    _eq(got, _plain(kind, fw, f2, r), "emulation vs plain")
    _eq(got, _jax_relax(kind, fw, f2, seg, col, w, n),
        "emulation vs reference")
    if case in ("all_ties", "zero_ties_nb1"):
        # the order is observable: some run's values added smallest first
        # give other bits than in arc order, which the sums keep
        differs = False
        cols = r.col.numpy()
        for v in range(n):
            xs = f2[0, cols[offsets[v]:offsets[v + 1]]]
            fwd = other = np.float32(0)
            for x, y in zip(xs, np.sort(xs)):
                fwd, other = np.float32(fwd + x), np.float32(other + y)
            assert fwd == got[1][0, v]
            differs |= fwd != other
        assert differs


@pytest.mark.parametrize("kind", ["mp", "cp"])
def test_dispatch_runs_the_plain_version_on_cpu(kind):
    fw, f2, seg, col, w, n = make_case("chunk_edges", kind, seed=1)
    r = _runs(seg, col, w, n)
    fn = multpath_segment_relax if kind == "mp" else centpath_segment_relax
    before = segment_relax_cuda.launches
    got = fn(torch.from_numpy(fw), torch.from_numpy(f2), r.col, r.seg, r.w,
             r.offsets)
    assert segment_relax_cuda.launches == before
    assert len(got) == (2 if kind == "mp" else 3)
    _eq([x.numpy() for x in got], _plain(kind, fw, f2, r), "dispatch")


def _operands():
    fw = torch.zeros(2, 3)
    return dict(fw=fw, f2=fw.clone(), col=torch.zeros(4, dtype=torch.int64),
                w=torch.zeros(4), offsets=torch.zeros(4, dtype=torch.int64))


@pytest.mark.parametrize("bad, match", [
    ({}, "CUDA tensors only"),
    ({"offsets": torch.zeros(3, dtype=torch.int64)}, "shapes"),
    ({"f2": torch.zeros(3, 2)}, "shapes"),
    ({"w": torch.zeros(5)}, "shapes"),
    ({"col": torch.zeros(2, 2, dtype=torch.int64)}, "shapes"),
    ({"fw": torch.zeros(2, 3, dtype=torch.float64)}, "float32"),
    ({"col": torch.zeros(4, dtype=torch.int32)}, "int64"),
])
@pytest.mark.parametrize("centpath", [False, True])
def test_segment_relax_wrapper_refuses(bad, match, centpath):
    """No quiet fallback: the wrapper takes well-formed CUDA tensors only,
    and refuses before it launches anything."""
    args = {**_operands(), **bad}
    before = segment_relax_cuda.launches
    with pytest.raises(ValueError, match=match):
        segment_relax_cuda(*args.values(), centpath=centpath)
    assert segment_relax_cuda.launches == before


def test_dispatch_has_no_path_for_another_device():
    meta = torch.zeros(2, 5, device="meta")
    off = torch.zeros(6, dtype=torch.int64)
    before = segment_relax_cuda.launches
    for fn in (multpath_segment_relax, centpath_segment_relax):
        with pytest.raises(ValueError, match="no path for device meta"):
            fn(meta, meta, off, off, off, off)
    assert segment_relax_cuda.launches == before


# ------------------------------------------------------------ on the card
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(CARD_CASES))
@pytest.mark.parametrize("kind", ["mp", "cp"])
def test_segment_relax_kernel_matches_plain_on_card(kind, case, cuda):
    fw, f2, seg, col, w, n = make_case(case, kind)
    r = _runs(seg, col, w, n)
    on = [x.to(cuda) for x in (torch.from_numpy(fw), torch.from_numpy(f2),
                               r.col, r.w, r.offsets)]
    before = segment_relax_cuda.launches
    for threshold in (0, 32, LONG_RUN):
        first = segment_relax_cuda(*on, centpath=kind == "cp",
                                   threshold=threshold)
        again = segment_relax_cuda(*on, centpath=kind == "cp",
                                   threshold=threshold)
        torch.cuda.synchronize()
        want = _plain(kind, fw, f2, r)
        for x, y, z in zip(first, again, want):
            assert torch.equal(x, y)
            np.testing.assert_array_equal(x.cpu().numpy(), z)
    assert segment_relax_cuda.launches == before + 6


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["coo", "csr"])
def test_sparse_mfbc_on_card_runs_the_segment_relax(backend, cuda):
    from repro_torch.core.brandes_ref import brandes_bc
    from repro_torch.core.mfbc import mfbc
    from repro_torch.graphs.generators import rmat

    g = rmat(7, 8, seed=3, weighted=True, max_weight=6).remove_isolated()[0]
    before = segment_relax_cuda.launches
    lam = mfbc(g, n_b=16, backend=backend)
    assert segment_relax_cuda.launches > before
    np.testing.assert_allclose(lam, brandes_bc(g), rtol=1e-5, atol=1e-8)
