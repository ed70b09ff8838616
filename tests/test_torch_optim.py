"""The port's optimizer and gradient compression against the reference's.

* Mirrors of the five tests of ``tests/test_optim.py`` on
  ``repro_torch.optim.adamw`` (the toy regression trained by
  ``train_lib.make_generic_train_step``).
* ``_q8`` bitwise equal to the reference's on identical inputs (stacked,
  2-D, 1-D and 0-D leaves; ``jnp.round`` and ``torch.round`` both round
  half to even).
* ``schedule``, ``global_norm`` and ``clip_by_global_norm`` against the
  reference's (rtol 1e-6).
* ``update`` against the reference's over 3 steps on a tree with stacked
  layer leaves, with f32 and with int8 moments, fed identical gradients:
  parameters and f32 moments within rtol 1e-6 (the two sides round their
  f32 scalars, ``b1 ** t`` and the cosine, on their own), int8 ``q``
  within one step of the reference's and bitwise on step 1, its scales
  within rtol 1e-5, bf16 ``v`` within one bf16 step.
* ``compress`` against the reference's on identical gradients and error
  buffers: top-k's kept set and payload and int8's payload bitwise, the
  new error buffers bitwise, ``wire_bytes`` equal; and a mirror of
  ``tests/test_fault_tolerance.py::test_grad_compression_error_feedback``
  for both kinds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JA
from repro.optim import grad_compress as JC
from repro_torch.optim import adamw
from repro_torch.optim import grad_compress as GC
from repro_torch import tree as tree_lib
from repro_torch.train.checkpoint import to_numpy
from repro_torch.train.train_lib import make_generic_train_step


def _np(tree):
    return tree_lib.tree_map(to_numpy, tree)


def _t(tree):
    return tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


# ---------------------------------------------------------------------------
# Mirrors of tests/test_optim.py
# ---------------------------------------------------------------------------


def _toy():
    rng = np.random.default_rng(0)
    Wt = torch.from_numpy(rng.normal(size=(16, 8)).astype(np.float32))
    X = torch.from_numpy(rng.normal(size=(256, 16)).astype(np.float32))
    return X, X @ Wt


def _train(md, steps=200, lr=3e-2):
    X, Y = _toy()
    cfg = adamw.AdamWConfig(lr=lr, warmup_steps=1, total_steps=steps,
                            weight_decay=0.0, moment_dtype=md)
    if md == "f32":  # the family-agnostic step: f32 moments
        init, step = make_generic_train_step(
            lambda p, b: torch.mean((X @ p["w"] - Y) ** 2),
            lambda gen: {"w": torch.zeros((16, 8))}, cfg)
        state = init(torch.Generator().manual_seed(0))
        for _ in range(steps):
            state, m = step(state, None)
        return float(m["loss"])
    params = {"w": torch.zeros((16, 8))}
    state = adamw.init_state(params, md)
    for _ in range(steps):
        w = params["w"].detach().requires_grad_()
        loss = torch.mean((X @ w - Y) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        adamw.update(cfg, {"w": g}, state, params)
    return float(loss.detach())


def test_adamw_converges_f32():
    assert _train("f32") < 1e-4


def test_adamw_converges_int8_moments():
    """8-bit-m / bf16-v moments must match f32 convergence on a toy task."""
    assert _train("int8") < 1e-3


def test_int8_state_is_smaller():
    params = {"w": torch.zeros((64, 64))}
    s32 = adamw.init_state(params, "f32")
    s8 = adamw.init_state(params, "int8")

    def nbytes(t):
        return sum(x.numel() * x.element_size()
                   for _, x in tree_lib.leaves(t))

    assert nbytes(s8) < 0.5 * nbytes(s32)


def test_schedule_warmup_and_decay():
    cfg = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100,
                            min_lr_frac=0.1)
    lrs = [float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32)))
           for s in (0, 9, 10, 50, 99)]
    assert lrs[0] < lrs[1] <= lrs[2]  # warmup rises
    assert lrs[2] > lrs[3] > lrs[4]  # cosine decays
    assert lrs[4] >= 0.1 * 0.99  # floor


def test_grad_clip():
    g = {"a": torch.full((10,), 10.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    assert float(norm) > 1.0
    assert abs(float(adamw.global_norm(clipped)) - 1.0) < 1e-5


# ---------------------------------------------------------------------------
# Against the reference
# ---------------------------------------------------------------------------


def _tree(rng, scale=1.0):
    """A stacked tree: layer leaves (3, ...) on dim 0, a 2-D embedding, a
    1-D norm scale and a 0-D scalar."""
    def n(*shape):
        return (scale * rng.normal(size=shape)).astype(np.float32)
    return {"embedding": n(40, 8), "final_norm": {"scale": n(8)},
            "temp": n(),
            "layers": {"attn": {"wq": n(3, 8, 2, 4), "wo": n(3, 8, 8)},
                       "norm": {"scale": n(3, 8)}}}


@pytest.mark.parametrize("shape", [(3, 8, 2, 4), (40, 8), (8,), ()],
                         ids=["stacked", "2d", "1d", "0d"])
def test_q8_bitwise(shape):
    rng = np.random.default_rng(1)
    x = rng.normal(size=shape).astype(np.float32)
    if x.ndim:
        x.reshape(-1)[:4] = [0.5, -1.5, 2.5, 0.0]  # halves and zero
    want = JA._q8(jnp.asarray(x))
    got = adamw._q8(torch.from_numpy(x))
    for k in ("q", "s"):
        assert got[k].shape == tuple(want[k].shape), k
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
    np.testing.assert_array_equal(adamw._dq8(got).numpy(),
                                  np.asarray(JA._dq8(want)))


def test_schedule_and_norms_match_reference():
    cfg = adamw.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=50)
    jcfg = JA.AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=50)
    for s in (0, 3, 6, 7, 20, 49, 60):
        np.testing.assert_allclose(
            float(adamw.schedule(cfg, torch.tensor(s, dtype=torch.int32))),
            float(JA.schedule(jcfg, jnp.int32(s))), rtol=1e-6)
    g = _tree(np.random.default_rng(2))
    np.testing.assert_allclose(float(adamw.global_norm(_t(g))),
                               float(JA.global_norm(g)), rtol=1e-6)
    got, gn = adamw.clip_by_global_norm(_t(g), 0.5)
    want, jn = JA.clip_by_global_norm(jax.tree.map(jnp.asarray, g), 0.5)
    np.testing.assert_allclose(float(gn), float(jn), rtol=1e-6)
    for (p, a), (_, b) in zip(tree_lib.leaves(got), tree_lib.leaves(want)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   err_msg="/".join(p))


@pytest.mark.parametrize("md", ["f32", "int8"])
def test_update_matches_reference(md):
    """Three steps of ``update`` on both sides, fed the same gradients,
    from the same parameters (the clip engages on step 0 only)."""
    rng = np.random.default_rng(3)
    params = _tree(rng, 0.5)
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                            moment_dtype=md)
    jcfg = JA.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10,
                          moment_dtype=md)
    tp = _t(params)
    ts = adamw.init_state(tp, md)
    jp = jax.tree.map(jnp.asarray, params)
    js = JA.init_state(jp, md)
    update = jax.jit(lambda g, s, p: JA.update(jcfg, g, s, p))
    for step in range(3):
        g = _tree(rng, 3.0 if step == 0 else 0.1)
        jp, js, jm = update(jax.tree.map(jnp.asarray, g), js, jp)
        tp, ts, tm = adamw.update(cfg, _t(g), ts, tp)
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-6,
                                       err_msg=k)
        assert int(ts["step"]) == int(js["step"]) == step + 1
        for (p, a), (_, b) in zip(tree_lib.leaves(_np(tp)),
                                  tree_lib.leaves(_np(jp))):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7,
                                       err_msg=f"step {step} {p}")
        jm_, jv = _np(js["m"]), _np(js["v"])
        tm_, tv = _np(ts["m"]), _np(ts["v"])
        if md == "f32":
            for got, want in ((tm_, jm_), (tv, jv)):
                for (p, a), (_, b) in zip(tree_lib.leaves(got),
                                          tree_lib.leaves(want)):
                    np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9,
                                               err_msg=f"step {step} {p}")
            continue
        for (p, a), (_, b) in zip(tree_lib.leaves(tm_),
                                  tree_lib.leaves(jm_)):
            if p[-1] == "q" and a.dtype == np.int8:
                d = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert d.max() <= (0 if step == 0 else 1), (step, p)
            else:  # the scales: an absmax of m, whose last bits differ
                np.testing.assert_allclose(a, b, rtol=1e-5,
                                           err_msg=f"step {step} {p}")
        for (p, a), (_, b) in zip(tree_lib.leaves(tv), tree_lib.leaves(jv)):
            assert a.dtype == np.dtype("V2") and b.dtype.name == "bfloat16"
            d = np.abs(a.view(np.int16).astype(np.int32)
                       - b.view(np.int16).astype(np.int32))
            assert d.max() <= 1, (step, p)  # one bf16 step


def _grads(rng):
    """Gradients and error buffers without ties in |g + err|."""
    g = _tree(rng)
    e = _tree(rng, 0.1)
    return g, e


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_compress_matches_reference(kind):
    rng = np.random.default_rng(4)
    g, e = _grads(rng)
    cfg = GC.CompressConfig(kind=kind, topk_ratio=0.25)
    jcfg = JC.CompressConfig(kind=kind, topk_ratio=0.25)
    dense, err, wire = GC.compress(cfg, _t(g), _t(e))
    jdense, jerr, jwire = JC.compress(jcfg, jax.tree.map(jnp.asarray, g),
                                      jax.tree.map(jnp.asarray, e))
    assert wire == int(jwire)
    for got, want in ((dense, jdense), (err, jerr)):
        for (p, a), (_, b) in zip(tree_lib.leaves(_np(got)),
                                  tree_lib.leaves(_np(want))):
            np.testing.assert_array_equal(a, b, err_msg="/".join(p))
    if kind == "topk":  # the kept set, leaf by leaf
        for (p, a), (_, b) in zip(tree_lib.leaves(_np(dense)),
                                  tree_lib.leaves(_np(jdense))):
            kept = np.flatnonzero(a)
            assert kept.size == max(1, int(a.size * 0.25)), p
            np.testing.assert_array_equal(kept, np.flatnonzero(b))
    none, _, raw = GC.compress(GC.CompressConfig(kind="none"), _t(g), _t(e))
    assert raw == JC.compress(JC.CompressConfig(kind="none"), g, e)[2]
    assert GC.compression_ratio(cfg, g) == JC.compression_ratio(jcfg, g)


@pytest.mark.parametrize("kind", ["topk", "int8"])
def test_grad_compression_error_feedback(kind):
    """Compression + error feedback preserves the gradient in total (the
    reference's test on the port)."""
    cfg = GC.CompressConfig(kind=kind, topk_ratio=0.25)
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    err = GC.init_error(g)
    sent_total = torch.zeros((64, 64))
    true_total = torch.zeros((64, 64))
    for _ in range(30):
        dense, err, wire = GC.compress(cfg, g, err)
        sent_total = sent_total + dense["w"]
        true_total = true_total + g["w"]
        assert wire < 64 * 64 * 4 or kind == "topk"
    resid = (sent_total - true_total).abs().max()
    scale = true_total.abs().max()
    assert float(resid / scale) < 0.1, float(resid / scale)
    assert GC.compression_ratio(cfg, g) < 1.0
