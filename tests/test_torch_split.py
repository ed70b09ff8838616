"""Split-K of the Hopper kernels, checked on the CPU.

The kernels of ``repro_torch.kernels`` cut the contraction into S slices
(``k_slices`` below mirrors ``blockIdx.z`` in ``csrc/*.cu``), reduce each slice one staged tile at a time in
two passes with no finiteness test, zero ``m`` (``p``, ``c``) where a
slice's ``w`` is not finite, and fold the slices in order with the monoid's combine. These
tests hold that arithmetic, written out in plain PyTorch, against the
unsplit plain product and against the JAX package's ``repro.kernels.ops``:
``w`` and ``c`` bitwise, ``m`` within rtol 1e-6, ``p`` within rtol 1e-5.
They also pin ``pick_splits``, the split count the wrappers choose.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jax_ops
from repro_torch.core import monoids
from repro_torch.core.monoids import Centpath, Multpath
from repro_torch.kernels.tropical_mm import (BK, BM, BN, WARPS_PER_BLOCK,
                                             pick_splits)

INF = np.inf
KINDS = ["empty", "ties", "random"]


def _inputs(kind, which, nb, n, n2, seed):
    """numpy (fw, f2, adjacency) of one input kind for one product."""
    rng = np.random.default_rng(seed)
    mp = which == "multpath"
    adj = np.where(rng.random((n, n2)) < 0.3,
                   rng.integers(1, 10, (n, n2)), INF).astype(np.float32)
    if kind == "empty":
        return (np.full((nb, n), INF if mp else -INF, np.float32),
                np.zeros((nb, n), np.float32), adj)
    if kind == "ties":  # complete structure, unit weights: every path ties
        return (np.full((nb, n), 1.0 if mp else 10.0, np.float32),
                np.full((nb, n), 2.0 if mp else 0.5, np.float32),
                np.ones((n, n2), np.float32))
    active = rng.random((nb, n)) < 0.5
    fw = np.where(active, rng.integers(0, 20, (nb, n)), INF if mp else -INF)
    f2 = rng.integers(1, 5, (nb, n)) if mp else rng.random((nb, n))
    return (fw.astype(np.float32),
            np.where(active, f2, 0.0).astype(np.float32), adj)


def k_slices(n, splits):
    """The contraction ranges [k0, k1) of the kernels' ``splits`` slices:
    ⌈k_tiles/S⌉ k-tiles of BK each, the last slice the rest."""
    k_tiles = -(-n // BK)
    kts = -(-k_tiles // splits)
    return [(min(n, z * kts * BK), min(n, (z + 1) * kts * BK))
            for z in range(splits)]


def _t(x):
    return torch.tensor(np.asarray(x, dtype=np.float32))


def _check(which, got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-6 if which == "multpath" else 1e-5)
    if which == "centpath":
        np.testing.assert_array_equal(np.asarray(got[2]),
                                      np.asarray(want[2]))


def _plain(which, fw, f2, adj, block):
    if which == "multpath":
        return tuple(monoids.multpath_relax_dense(Multpath(fw, f2), adj,
                                                  block=block))
    return tuple(monoids.centpath_relax_dense(Centpath(fw, f2, None), adj,
                                              block=block))


def _fold(which, parts):
    """The slices' partials combined in slice order."""
    if which == "multpath":
        acc = Multpath(*parts[0])
        for p in parts[1:]:
            acc = monoids.multpath_combine(acc, Multpath(*p))
    else:
        acc = Centpath(*parts[0])
        for p in parts[1:]:
            acc = monoids.centpath_combine(acc, Centpath(*p))
    return tuple(acc)


def _emulate_slice(which, fw, f2, adj):
    """One slice as a kernel thread reduces it, BK k-steps (one staged
    tile) at a time: pass 1 takes the tile's best candidate, the merge
    drops the sums when it is strictly better than the running ``w``, and
    pass 2 adds ``m`` (``p`` and 1) of each candidate that ties the new
    ``w``, with no finiteness test. Then the epilogue zeroing."""
    nb, n2 = fw.shape[0], adj.shape[1]
    mp = which == "multpath"
    if not mp:  # the load-time guard of centpath_mm.cu
        fw = torch.where(torch.isfinite(fw), fw, -INF)
        adj = torch.where(torch.isfinite(adj), adj, INF)
    w = torch.full((nb, n2), INF if mp else -INF)
    x = torch.zeros((nb, n2))
    c = torch.zeros((nb, n2))
    for k0 in range(0, fw.shape[1], BK):
        cand = [fw[:, k:k + 1] + adj[k] if mp else fw[:, k:k + 1] - adj[k]
                for k in range(k0, min(k0 + BK, fw.shape[1]))]
        best = w.clone()
        for cd in cand:  # pass 1, from the identity
            best = torch.minimum(best, cd) if mp else torch.maximum(best, cd)
        better = best < w if mp else best > w
        x = torch.where(better, 0.0, x)
        c = torch.where(better, 0.0, c)
        w = best
        for k, cd in zip(range(k0, k0 + BK), cand):  # pass 2
            tie = cd == w
            x = torch.where(tie, x + f2[:, k:k + 1], x)
            c = torch.where(tie, c + 1.0, c)
    live = torch.isfinite(w)
    x = torch.where(live, x, 0.0)
    if mp:
        return w, x
    return w, x, torch.where(live, c, 0.0)


@pytest.mark.parametrize("splits", [1, 2, 3, 7])
@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("which", ["multpath", "centpath"])
def test_split_plain_product_folds_to_unsplit(which, kind, splits):
    """Slices of BK = 16 k-tiles cut the plain version's 24-wide blocks
    mid-block, and at n = 150 the last slice is shorter than the rest."""
    nb, n, n2 = 8, 150, 40
    fw, f2, adj = (_t(x) for x in _inputs(kind, which, nb, n, n2, splits))
    bounds = k_slices(n, splits)
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    assert any(k1 % 24 for _, k1 in bounds[:-1]) or splits == 1
    parts = [_plain(which, fw[:, k0:k1], f2[:, k0:k1], adj[k0:k1], 24)
             for k0, k1 in bounds if k1 > k0]
    got = _fold(which, parts)
    _check(which, got, _plain(which, fw, f2, adj, 24))
    jax_fn = (jax_ops.multpath_matmul if which == "multpath"
              else jax_ops.centpath_matmul)
    _check(which, got, jax_fn(*(jnp.asarray(x.numpy())
                                for x in (fw, f2, adj))))


@pytest.mark.parametrize("splits", [1, 3])
@pytest.mark.parametrize("which,kind", [
    *((w, k) for w in ("multpath", "centpath") for k in KINDS),
    ("centpath", "nonfinite")])
def test_kernel_update_without_isfinite_matches_plain(which, kind, splits):
    """The kernels' two-pass tile update (no isfinite), epilogue zeroing
    and in-order fold, at (8, 64, 48), equal the plain version: ``w`` and
    ``c`` bitwise. Three columns have no edge, so their ties at the
    identity would leave garbage in ``m``/``p``/``c`` without the
    epilogue's zeroing. ``nonfinite`` puts +inf and NaN into centpath's F.w
    and B, which the load-time guard maps to -inf and +inf."""
    nb, n, n2 = 8, 64, 48
    fw, f2, adj = (_t(x) for x in _inputs(
        "random" if kind == "nonfinite" else kind, which, nb, n, n2, 5))
    adj[:, :3] = INF  # no edge into three columns: every candidate inf
    if kind == "nonfinite":
        fw[0, :8] = INF
        fw[1, 3] = float("nan")
        adj[5, :] = -INF
        adj[6, 2] = float("nan")
    parts = [_emulate_slice(which, fw[:, k0:k1], f2[:, k0:k1], adj[k0:k1])
             for k0, k1 in k_slices(n, splits)]
    got = _fold(which, parts)
    want = _plain(which, fw, f2, adj, 16)
    np.testing.assert_array_equal(got[0].numpy(), want[0].numpy())
    _check(which, got, want)


def test_pick_splits_fills_the_card_and_stays_in_range():
    sms = 132
    for nb, n, n2 in [(64, 3342, 3342), (64, 12536, 12536), (8, 16, 16),
                      (64, 17, 1000), (1, 5000, 64), (130, 257, 129),
                      (64, 4096, 4096), (1000, 64, 5000), (3, 0, 7)]:
        s = pick_splits(nb, n, n2, sms)
        k_tiles = -(-n // BK)
        assert 1 <= s <= max(1, k_tiles), (nb, n, n2, s)
        bounds = k_slices(n, s)
        assert all(k1 > k0 for k0, k1 in bounds) or n == 0
        assert bounds[-1][1] == n
    tiles = -(-64 // BM) * -(-3342 // BN)
    blocks = tiles * pick_splits(64, 3342, 3342, sms)
    assert blocks >= 16 * sms / WARPS_PER_BLOCK  # >= 16 warps per SM
    assert pick_splits(8, 16, 16, sms) == 1
    assert pick_splits(64, 17, 1000, sms) == 1  # k shorter than one slice


@pytest.mark.parametrize("n", [1, 15, 16, 17, 150, 3342])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
def test_k_slices_tile_the_contraction_in_order(n, splits):
    bounds = k_slices(n, splits)
    assert len(bounds) == splits
    assert bounds[0][0] == 0 and bounds[-1][1] == n
    for (a0, a1), (b0, b1) in zip(bounds, bounds[1:]):
        assert a1 == b0 and a0 <= a1
        assert a0 % BK == 0 or a0 == n  # slices past k are empty


# -- the live-k walk ---------------------------------------------------------
# Before each launch on the card, ``kernels/live_k.py`` packs each slice's
# live columns of F (a column is dead where every row's F.w is +inf for
# multpath, not finite for centpath), and the kernel walks a slice's live k
# alone in tiles of BK, in ascending order. These tests hold that walk,
# emulated, bitwise to the full walk at the same S in every field, with
# non-integer m and p (so the order of their sums shows), dead columns that
# carry garbage in m/p (ties at the identity that the epilogue must drop)
# and any weights in A's dead rows.
SHARES = [0.0, "one", 0.01, 0.4, 1.0]


def _with_dead_columns(which, nb, n, n2, share, seed):
    """(fw, f2, adj, live): F whose live columns are ``share`` of n (or one
    column), each with at least one live row, the rest of F the identity
    (centpath's as -inf, +inf and NaN) over garbage m/p; A random in every
    row."""
    rng = np.random.default_rng(seed)
    mp = which == "multpath"
    k_live = 1 if share == "one" else int(round(share * n))
    live = np.zeros(n, bool)
    live[rng.permutation(n)[:k_live]] = True
    active = (rng.random((nb, n)) < 0.5) & live
    active[rng.integers(0, nb, n), np.arange(n)] |= live
    dead_w = (np.full((nb, n), INF) if mp else
              rng.choice(np.array([-INF, INF, np.nan], np.float32), (nb, n)))
    fw = np.where(active, rng.integers(0, 20, (nb, n)), dead_w)
    f2 = np.where(active, rng.random((nb, n)) * 7, rng.random((nb, n)))
    adj = np.where(rng.random((n, n2)) < 0.3,
                   rng.integers(1, 10, (n, n2)), INF)
    return (_t(fw), _t(f2), _t(adj), torch.from_numpy(live))


@pytest.mark.parametrize("share", SHARES)
@pytest.mark.parametrize("splits", [1, 2, 4])
@pytest.mark.parametrize("which", ["multpath", "centpath"])
def test_live_k_walk_is_bitwise_the_full_walk(which, splits, share):
    """Each slice's live k, packed by ``live_k_ref`` and walked in tiles of
    BK, folds to the full sweep's outputs bitwise, in w, m, p and c, at
    n = 150 (a ragged last slice)."""
    from repro_torch.kernels.live_k import live_k_ref

    nb, n, n2 = 8, 150, 40
    fw, f2, adj, live = _with_dead_columns(which, nb, n, n2, share,
                                           splits * 10 + len(str(share)))
    packed = live_k_ref(fw, f2, splits, finite=which == "centpath")
    assert int(packed.counts[-1]) == int(live.sum())
    full, walked = [], []
    for z, (k0, k1) in enumerate(k_slices(n, splits)):
        full.append(_emulate_slice(which, fw[:, k0:k1], f2[:, k0:k1],
                                   adj[k0:k1]))
        cnt = int(packed.counts[z])
        ks = packed.idx[k0:k0 + cnt].long()
        assert torch.equal(ks, torch.nonzero(live[k0:k1]).flatten() + k0)
        walked.append(_emulate_slice(which, packed.w[:, k0:k0 + cnt],
                                     packed.x[:, k0:k0 + cnt], adj[ks]))
    for x, y in zip(_fold(which, walked), _fold(which, full)):
        assert torch.equal(x, y)
    _check(which, _fold(which, walked), _plain(which, fw, f2, adj, 16))


@pytest.mark.parametrize("n", [1, 15, 16, 17, 150, 3342])
@pytest.mark.parametrize("splits", [1, 2, 3, 7, 64])
def test_live_k_slices_are_the_kernels_slices(n, splits):
    from repro_torch.kernels import live_k

    span = live_k.slice_len(n, splits)
    assert [(min(n, z * span), min(n, (z + 1) * span))
            for z in range(splits)] == k_slices(n, splits)
