"""``repro_torch.core.monoids`` against ``repro.core.monoids``.

Identical numpy inputs from a seed go through both packages. Weights and
counts must be bitwise equal (integer-valued float32 is exact below 2**24);
multiplicities ``m`` are held at rtol 1e-6 and centrality factors ``p`` at
rtol 1e-5, because the two sum their ties in different orders.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import monoids as jm
from repro_torch.core import monoids as tm

INF = np.inf


def _t(x):
    return torch.from_numpy(np.array(x, dtype=np.float32))


def _mp(rng, shape, density=0.5, wmax=6):
    active = rng.random(shape) < density
    w = np.where(active, rng.integers(0, wmax, shape), INF).astype(np.float32)
    m = np.where(active, rng.integers(1, 5, shape), 0).astype(np.float32)
    return w, m


def _cp(rng, shape, density=0.5, wmax=6):
    active = rng.random(shape) < density
    w = np.where(active, rng.integers(0, wmax, shape), -INF).astype(np.float32)
    p = np.where(active, rng.random(shape), 0).astype(np.float32)
    c = np.where(active, rng.integers(1, 4, shape), 0).astype(np.float32)
    return w, p, c


def _adj(rng, n, n2, density=0.3):
    a = rng.integers(1, 4, (n, n2)).astype(np.float32)
    return np.where(rng.random((n, n2)) < density, a, INF).astype(np.float32)


@pytest.mark.parametrize("seed", range(3))
def test_multpath_combine_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x, y = _mp(rng, (6, 40)), _mp(rng, (6, 40))
    want = jm.multpath_combine(jm.Multpath(*map(jnp.asarray, x)),
                               jm.Multpath(*map(jnp.asarray, y)))
    got = tm.multpath_combine(tm.Multpath(*map(_t, x)),
                              tm.Multpath(*map(_t, y)))
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_allclose(got.m.numpy(), np.asarray(want.m), rtol=1e-6)


@pytest.mark.parametrize("seed", range(3))
def test_centpath_combine_matches_reference(seed):
    rng = np.random.default_rng(seed)
    x, y = _cp(rng, (6, 40)), _cp(rng, (6, 40))
    want = jm.centpath_combine(jm.Centpath(*map(jnp.asarray, x)),
                               jm.Centpath(*map(jnp.asarray, y)))
    got = tm.centpath_combine(tm.Centpath(*map(_t, x)),
                              tm.Centpath(*map(_t, y)))
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-5)
    np.testing.assert_array_equal(got.c.numpy(), np.asarray(want.c))


RELAX_SHAPES = [(4, 20, 20, 8), (8, 64, 48, 16), (3, 33, 17, 256),
                (1, 50, 50, 7)]


@pytest.mark.parametrize("nb,n,n2,block", RELAX_SHAPES)
def test_multpath_relax_dense_matches_reference(nb, n, n2, block):
    rng = np.random.default_rng(nb * 100 + n)
    fw, fm = _mp(rng, (nb, n))
    a = _adj(rng, n, n2)
    want = jm.multpath_relax_dense(
        jm.Multpath(jnp.asarray(fw), jnp.asarray(fm)), jnp.asarray(a),
        block=block)
    got = tm.multpath_relax_dense(tm.Multpath(_t(fw), _t(fm)), _t(a),
                                  block=block)
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_allclose(got.m.numpy(), np.asarray(want.m), rtol=1e-6)


@pytest.mark.parametrize("nb,n,n2,block", RELAX_SHAPES)
def test_centpath_relax_dense_matches_reference(nb, n, n2, block):
    rng = np.random.default_rng(nb * 100 + n2)
    fw, fp, _ = _cp(rng, (nb, n))
    b = _adj(rng, n, n2)
    want = jm.centpath_relax_dense(
        jm.Centpath(jnp.asarray(fw), jnp.asarray(fp), jnp.zeros_like(fp)),
        jnp.asarray(b), block=block)
    got = tm.centpath_relax_dense(tm.Centpath(_t(fw), _t(fp), None), _t(b),
                                  block=block)
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_allclose(got.p.numpy(), np.asarray(want.p), rtol=1e-5)
    np.testing.assert_array_equal(got.c.numpy(), np.asarray(want.c))


@pytest.mark.parametrize("nb,n,block", [(4, 30, 8), (6, 64, 16), (2, 17, 256)])
def test_count_sp_children_dense_matches_reference(nb, n, block):
    rng = np.random.default_rng(n)
    tw, _ = _mp(rng, (nb, n), density=0.8, wmax=8)
    a = _adj(rng, n, n, density=0.4)
    want = jm.count_sp_children_dense(jnp.asarray(tw), jnp.asarray(a),
                                      block=block)
    got = tm.count_sp_children_dense(_t(tw), _t(a), block=block)
    assert got.dtype == torch.int32
    assert int(got.sum()) > 0  # the inputs do hold SP-DAG children
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("nb,n,block", [(4, 30, 8), (6, 64, 16), (2, 17, 256)])
def test_dense_adj_child_count_on_cpu_matches_reference(nb, n, block):
    """``DenseAdj.count_sp_children`` on a CPU ``Tw`` (the plain form, the
    card's kernel being for CUDA tensors) against the reference's count,
    with ±0.0 weights and distances and a row of +inf among the inputs."""
    from repro_torch.core.adjacency import DenseAdj

    rng = np.random.default_rng(n + 1)
    tw, _ = _mp(rng, (nb, n), density=0.8, wmax=8)
    tw[rng.random(tw.shape) < 0.1] = -0.0
    tw[0] = INF
    a = _adj(rng, n, n, density=0.4)
    a[rng.random(a.shape) < 0.1] = -0.0
    want = jm.count_sp_children_dense(jnp.asarray(tw), jnp.asarray(a),
                                      block=block)
    got = DenseAdj(_t(a), block=block).count_sp_children(_t(tw))
    assert got.dtype == torch.int32 and int(got.sum()) > 0
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("b", [
    [[INF, 1.0], [INF, INF]],  # no edge vs an inactive frontier entry
    [[-INF, -1.0], [INF, -INF]],  # (-inf) - (-w) and (-inf) - (-inf)
])
def test_centpath_no_nan_on_inactive_vs_noedge(b):
    fw = np.array([[-INF, 0.0]], np.float32)
    fp = np.array([[0.0, 1.0]], np.float32)
    b = np.array(b, np.float32)
    want = jm.centpath_relax_dense(
        jm.Centpath(jnp.asarray(fw), jnp.asarray(fp), jnp.zeros_like(fp)),
        jnp.asarray(b))
    got = tm.centpath_relax_dense(tm.Centpath(_t(fw), _t(fp), None), _t(b))
    assert not torch.isnan(got.w).any()
    assert got.w[0, 0] == -INF
    np.testing.assert_array_equal(got.w.numpy(), np.asarray(want.w))
    np.testing.assert_array_equal(got.c.numpy(), np.asarray(want.c))
