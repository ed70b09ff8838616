"""``repro_torch.kernels`` against ``repro.kernels``, and on the card.

On CPU tensors ``repro_torch.kernels.ops`` runs the plain PyTorch versions;
they are held against ``repro.kernels.ops`` (the Pallas kernels, which
interpret on the CPU) over the shape sweep of ``tests/test_kernels.py``, an
empty frontier and tie-heavy inputs: ``w`` and ``c`` bitwise, ``m`` within
rtol 1e-6, ``p`` within rtol 1e-5.

The tests marked ``cuda`` hold each Hopper kernel against its plain version
on the card and check that the launch counter moves (the sparse-relax
kernel's are in ``tests/test_torch_segment_relax.py``); they skip on a
host without a card. On the card they run with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels.py
"""
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _build, ops, ref
from repro_torch.kernels.centpath_mm import centpath_matmul_cuda
from repro_torch.kernels.tropical_mm import multpath_matmul_cuda

INF = np.inf
SHAPES = [(8, 16, 16), (8, 128, 128), (16, 200, 136), (128, 128, 256),
          (1, 64, 300), (130, 257, 129)]
# On the card also shapes that split the contraction: the scale-12 main
# path's, one with k shorter than a slice, and one with a single row.
CARD_SHAPES = SHAPES + [(64, 3342, 3342), (64, 17, 1000), (1, 5000, 64)]


@pytest.fixture
def ref_ops():
    """``repro.kernels.ops`` (the JAX package; absent on the card's host)."""
    pytest.importorskip("jax")
    from repro.kernels import ops as jax_ops
    return jax_ops


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    return torch.device("cuda")


def _t(x, device="cpu"):
    return torch.tensor(np.asarray(x, dtype=np.float32), device=device)


def _rand_multpath(rng, nb, n, density=0.5):
    active = rng.random((nb, n)) < density
    fw = np.where(active, rng.integers(0, 20, (nb, n)), INF)
    fm = np.where(active, rng.integers(1, 5, (nb, n)), 0.0)
    return fw.astype(np.float32), fm.astype(np.float32)


def _rand_centpath(rng, nb, n, density=0.5):
    active = rng.random((nb, n)) < density
    fw = np.where(active, rng.integers(0, 20, (nb, n)), -INF)
    fp = np.where(active, rng.random((nb, n)), 0.0)
    return fw.astype(np.float32), fp.astype(np.float32)


def _rand_adj(rng, n, n2, density=0.3):
    a = rng.integers(1, 10, (n, n2)).astype(np.float32)
    return np.where(rng.random((n, n2)) < density, a, INF).astype(np.float32)


def _inputs(kind, which, nb, n, n2, seed):
    """numpy (fw, f2, adjacency) of one input kind for one product."""
    rng = np.random.default_rng(seed)
    mp = which == "multpath"
    if kind == "empty":
        return (np.full((nb, n), INF if mp else -INF, np.float32),
                np.zeros((nb, n), np.float32), _rand_adj(rng, n, n2))
    if kind == "ties":  # complete structure, unit weights: every path ties
        return (np.full((nb, n), 1.0 if mp else 10.0, np.float32),
                np.full((nb, n), 2.0 if mp else 0.5, np.float32),
                np.ones((n, n2), np.float32))
    f = _rand_multpath(rng, nb, n) if mp else _rand_centpath(rng, nb, n)
    return (*f, _rand_adj(rng, n, n2))


def _assert_multpath(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-6)


def _assert_centpath(got, want):
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(want[0]))
    np.testing.assert_allclose(np.asarray(got[1]), np.asarray(want[1]),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(got[2]), np.asarray(want[2]))


@pytest.mark.parametrize("nb,n,n2", SHAPES)
def test_multpath_matmul_matches_reference(nb, n, n2, ref_ops):
    import jax.numpy as jnp
    fw, fm, a = _inputs("random", "multpath", nb, n, n2, nb * 1000 + n)
    got = ops.multpath_matmul(_t(fw), _t(fm), _t(a))
    _assert_multpath(got, ref_ops.multpath_matmul(
        jnp.asarray(fw), jnp.asarray(fm), jnp.asarray(a)))
    _assert_multpath(got, ref.multpath_matmul_ref(_t(fw), _t(fm), _t(a)))


@pytest.mark.parametrize("nb,n,n2", SHAPES)
def test_centpath_matmul_matches_reference(nb, n, n2, ref_ops):
    import jax.numpy as jnp
    fw, fp, b = _inputs("random", "centpath", nb, n, n2, nb * 7 + n2)
    got = ops.centpath_matmul(_t(fw), _t(fp), _t(b))
    _assert_centpath(got, ref_ops.centpath_matmul(
        jnp.asarray(fw), jnp.asarray(fp), jnp.asarray(b)))
    _assert_centpath(got, ref.centpath_matmul_ref(_t(fw), _t(fp), _t(b)))


@pytest.mark.parametrize("kind", ["empty", "ties"])
@pytest.mark.parametrize("which", ["multpath", "centpath"])
def test_special_frontiers_match_reference(kind, which, ref_ops):
    import jax.numpy as jnp
    fw, f2, adj = _inputs(kind, which, 8, 64, 48, 0)
    port = ops.multpath_matmul if which == "multpath" else ops.centpath_matmul
    jax_fn = (ref_ops.multpath_matmul if which == "multpath"
              else ref_ops.centpath_matmul)
    check = _assert_multpath if which == "multpath" else _assert_centpath
    got = port(_t(fw), _t(f2), _t(adj))
    check(got, jax_fn(jnp.asarray(fw), jnp.asarray(f2), jnp.asarray(adj)))
    if kind == "empty":  # all inactive in, all inactive out
        assert not torch.isfinite(got[0]).any()
        assert (got[1] == 0).all()
    elif which == "multpath":
        assert (got[0] == 2.0).all() and (got[1] == 2.0 * 64).all()
    else:
        assert (got[0] == 9.0).all() and (got[2] == 64.0).all()


def test_pick_block_matches_reference(ref_ops):
    from repro.kernels.ops import _pick_block as jax_pick
    for dim in (1, 7, 16, 63, 64, 65, 200, 4096):
        for pref in (8, 128, 512):
            assert ops._pick_block(dim, pref) == jax_pick(dim, pref)


def test_cuda_wrappers_refuse_cpu_tensors():
    """No quiet fallback: the kernel wrappers take CUDA tensors only."""
    x = torch.zeros(4, 8)
    a = torch.zeros(8, 8)
    before = (multpath_matmul_cuda.launches, centpath_matmul_cuda.launches)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        multpath_matmul_cuda(x, x, a)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        centpath_matmul_cuda(x, x, a)
    assert (multpath_matmul_cuda.launches,
            centpath_matmul_cuda.launches) == before


def test_ops_have_no_path_for_other_devices():
    x = torch.zeros(4, 8, device="meta")
    a = torch.zeros(8, 8, device="meta")
    with pytest.raises(ValueError, match="no path for device meta"):
        ops.multpath_matmul(x, x, a)
    with pytest.raises(ValueError, match="no path for device meta"):
        ops.centpath_matmul(x, x, a)


@pytest.mark.parametrize("name", _build.SOURCES)
def test_build_command_targets_hopper_without_fast_math(name):
    out = Path("/nonexistent") / f"{name}.so"
    cmd = _build.nvcc_command("nvcc", name, out)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert not any("fast_math" in c or "fast-math" in c for c in cmd)
    assert cmd[-1].endswith(f"csrc/{name}.cu") and Path(cmd[-1]).is_file()
    lib = _build.library_path(name)
    assert lib.parent == _build.BUILD_DIR
    assert lib.parent.parent.name == "build"
    assert lib.name.startswith(name + "-") and lib.suffix == ".so"


# -- on the card ----------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n,n2", CARD_SHAPES)
def test_multpath_kernel_matches_plain_on_card(nb, n, n2, cuda):
    for kind in ("empty", "ties", "random"):
        fw, fm, a = (_t(x, cuda) for x in
                     _inputs(kind, "multpath", nb, n, n2, nb + n))
        before = multpath_matmul_cuda.launches
        got = ops.multpath_matmul(fw, fm, a)
        torch.cuda.synchronize()
        assert multpath_matmul_cuda.launches == before + 1
        want = ref.multpath_matmul_ref(fw, fm, a)
        assert torch.equal(got[0], want[0]), kind
        torch.testing.assert_close(got[1], want[1], rtol=1e-6, atol=0.0)


@pytest.mark.cuda
@pytest.mark.parametrize("nb,n,n2", CARD_SHAPES)
def test_centpath_kernel_matches_plain_on_card(nb, n, n2, cuda):
    for kind in ("empty", "ties", "random"):
        fw, fp, b = (_t(x, cuda) for x in
                     _inputs(kind, "centpath", nb, n, n2, nb + n2))
        before = centpath_matmul_cuda.launches
        got = ops.centpath_matmul(fw, fp, b)
        torch.cuda.synchronize()
        assert centpath_matmul_cuda.launches == before + 1
        want = ref.centpath_matmul_ref(fw, fp, b)
        assert torch.equal(got[0], want[0]), kind
        torch.testing.assert_close(got[1], want[1], rtol=1e-5, atol=0.0)
        assert torch.equal(got[2], want[2]), kind


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["multpath", "centpath"])
@pytest.mark.parametrize("nb,n,n2", [(64, 3342, 3342), (130, 257, 129)])
def test_kernel_is_bitwise_repeatable_on_card(which, nb, n, n2, cuda):
    """Split-K folds its slices in order, with no atomics: two launches on
    the same inputs agree bitwise in every output field."""
    fw, f2, adj = (_t(x, cuda) for x in _inputs("random", which, nb, n, n2,
                                                 nb + n))
    fn = ops.multpath_matmul if which == "multpath" else ops.centpath_matmul
    first = fn(fw, f2, adj)
    second = fn(fw, f2, adj)
    torch.cuda.synchronize()
    for x, y in zip(first, second):
        assert torch.equal(x, y)


@pytest.mark.cuda
def test_mfbc_on_card_runs_the_kernels(cuda):
    from repro_torch.core.brandes_ref import brandes_bc
    from repro_torch.core.mfbc import mfbc
    from repro_torch.graphs.generators import erdos_renyi

    g = erdos_renyi(48, 0.12, seed=3, weighted=True, max_weight=6)
    before = (multpath_matmul_cuda.launches, centpath_matmul_cuda.launches)
    lam = mfbc(g, n_b=16)
    assert multpath_matmul_cuda.launches > before[0]
    assert centpath_matmul_cuda.launches > before[1]
    np.testing.assert_allclose(lam, brandes_bc(g), rtol=1e-5, atol=1e-8)


@pytest.mark.cuda
def test_one_row_relax_on_a_for_batches_adjacency(cuda):
    """The components sweep relaxes one (1, n) row on an adjacency whose
    split count was fixed for 64 rows (``DenseAdj.for_batches``), with
    zero-weight arcs: the row matches the plain version and is bitwise
    the same row relaxed in a 64-row batch."""
    from repro_torch.core.adjacency import DenseAdj
    from repro_torch.core.monoids import Centpath, Multpath

    n = 3342
    rng = np.random.default_rng(1)
    a = _rand_adj(rng, n, n, density=0.01)
    a[a == 1.0] = 0.0  # zero-weight arcs: every label that reaches ties
    adj = DenseAdj(_t(a, cuda)).for_batches(64)
    fw, fm = (_t(x, cuda) for x in _rand_multpath(rng, 64, n))
    cw, cp = (_t(x, cuda) for x in _rand_centpath(rng, 64, n))
    before = (multpath_matmul_cuda.launches, centpath_matmul_cuda.launches)
    row = adj.relax_mp(Multpath(fw[:1], fm[:1]))
    batch = adj.relax_mp(Multpath(fw, fm))
    crow = adj.relax_cp(Centpath(cw[:1], cp[:1], None))
    cbatch = adj.relax_cp(Centpath(cw, cp, None))
    torch.cuda.synchronize()
    assert (multpath_matmul_cuda.launches,
            centpath_matmul_cuda.launches) == (before[0] + 2, before[1] + 2)
    want = ref.multpath_matmul_ref(fw[:1], fm[:1], adj.a)
    assert torch.equal(row.w, want[0])
    torch.testing.assert_close(row.m, want[1], rtol=1e-6, atol=0.0)
    cwant = ref.centpath_matmul_ref(cw[:1], cp[:1], adj.at)
    assert torch.equal(crow.w, cwant[0]) and torch.equal(crow.c, cwant[2])
    torch.testing.assert_close(crow.p, cwant[1], rtol=1e-5, atol=0.0)
    for x, y in zip(tuple(row) + tuple(crow), tuple(batch) + tuple(cbatch)):
        assert torch.equal(x, y[:1])
