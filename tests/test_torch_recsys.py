"""The port's xDeepFM (``repro_torch.models.recsys``) against
``repro.models.recsys``.

On the same ids (drawn from a seed with numpy) and the reference's
parameters carried bit for bit: ``embedding_bag`` (sum, mean, weights,
and the raise on another combine) at rtol 1e-5, atol 1e-6; ``forward``
and ``retrieval_score`` within 1e-4 of their outputs' largest magnitude;
``bce_loss`` and its gradient against ``jax.value_and_grad`` (each leaf
within 1e-4 of its largest magnitude); ``init_shapes``, ``total_vocab``,
``n_params`` and the init distribution against the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import recsys as JR
from repro_torch import tree as tree_lib
from repro_torch.models import recsys as R

SMALL = dict(n_fields=5, vocab_per_field=40, embed_dim=6, cin_layers=(7, 5),
             mlp_layers=(12, 9))


def both(seed: int = 0, **over):
    cfg = R.XDeepFMConfig("x", **{**SMALL, **over})
    jcfg = JR.XDeepFMConfig("x", **{**SMALL, **over})
    jp = JR.init_params(jcfg, jax.random.key(seed))
    # the reference's linear and bias start at zero: give them values, so
    # that their lookups are checked
    rng = np.random.default_rng(seed)
    jp["linear"] = jnp.asarray(rng.normal(size=jcfg.total_vocab), jnp.float32)
    jp["bias"] = jnp.float32(0.3)
    return (R.params_from_reference(jax.tree.map(np.asarray, jp), "cpu"), jp,
            cfg, jcfg)


def ids_of(cfg, rows: int, hot: int = 1, seed: int = 0) -> np.ndarray:
    return np.random.default_rng(seed).integers(
        0, cfg.total_vocab, (rows, cfg.n_fields, hot)).astype(np.int32)


def close_to_scale(got, want, tol: float = 1e-4, what: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@pytest.mark.parametrize("combine,weighted", [("sum", False), ("mean", False),
                                              ("sum", True), ("mean", True)])
def test_embedding_bag_matches_reference(combine, weighted):
    p, jp, cfg, _ = both()
    ids = ids_of(cfg, 9, hot=3, seed=1)
    w = (np.random.default_rng(2).random(ids.shape).astype(np.float32)
         if weighted else None)
    got = R.embedding_bag(p["table"], torch.from_numpy(ids),
                          None if w is None else torch.from_numpy(w),
                          combine)
    want = JR.embedding_bag(jp["table"], jnp.asarray(ids),
                            None if w is None else jnp.asarray(w), combine)
    assert got.shape == (9, cfg.n_fields, cfg.embed_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_embedding_bag_raises_on_another_combine():
    p, jp, cfg, _ = both()
    ids = ids_of(cfg, 2)
    with pytest.raises(ValueError, match="max"):
        R.embedding_bag(p["table"], torch.from_numpy(ids), combine="max")
    with pytest.raises(ValueError, match="max"):
        JR.embedding_bag(jp["table"], jnp.asarray(ids), combine="max")


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_matches_reference(seed):
    p, jp, cfg, jcfg = both(seed)
    ids = ids_of(cfg, 33, seed=seed)
    got = R.forward(cfg, p, torch.from_numpy(ids))
    want = JR.forward(jcfg, jp, jnp.asarray(ids))
    assert got.shape == (33,) and got.dtype == torch.float32
    close_to_scale(got.numpy(), want)


def test_bce_loss_and_grad_match_reference():
    p, jp, cfg, jcfg = both(2)
    ids = ids_of(cfg, 40, seed=3)
    lbl = np.random.default_rng(4).integers(0, 2, 40).astype(np.float32)
    jl, jg = jax.value_and_grad(
        lambda q: JR.bce_loss(jcfg, q, jnp.asarray(ids), jnp.asarray(lbl)))(jp)
    q = tree_lib.tree_map(lambda t: t.clone().requires_grad_(), p)
    loss = R.bce_loss(cfg, q, torch.from_numpy(ids), torch.from_numpy(lbl))
    pairs = tree_lib.leaves(q)
    grads = torch.autograd.grad(loss, [t for _, t in pairs])
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = jax.tree.leaves(jg)
    assert [p for p, _ in pairs] == [
        tuple(getattr(k, "key", getattr(k, "idx", None)) for k in path)
        for path, _ in jax.tree_util.tree_leaves_with_path(jg)]
    for (path, _), g, w in zip(pairs, grads, want):
        close_to_scale(g.numpy(), w, what=str(path))


def test_retrieval_score_matches_reference():
    p, jp, cfg, jcfg = both(3)
    q = ids_of(cfg, 1, seed=5)
    c = ids_of(cfg, 257, seed=6)
    got = R.retrieval_score(cfg, p, torch.from_numpy(q), torch.from_numpy(c))
    want = JR.retrieval_score(jcfg, jp, jnp.asarray(q), jnp.asarray(c))
    assert got.shape == (257,)
    close_to_scale(got.numpy(), want)


@pytest.mark.parametrize("over", [{}, dict(n_fields=39, vocab_per_field=10,
                                          embed_dim=10,
                                          cin_layers=(200, 200, 200),
                                          mlp_layers=(400, 400))])
def test_shapes_vocab_and_counts_match_reference(over):
    cfg = R.XDeepFMConfig("x", **{**SMALL, **over})
    jcfg = JR.XDeepFMConfig("x", **{**SMALL, **over})
    assert R.init_shapes(cfg) == JR.init_shapes(jcfg)
    assert cfg.total_vocab == jcfg.total_vocab
    assert cfg.total_vocab % 512 == 0
    assert cfg.n_params() == jcfg.n_params()
    p = R.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    assert sum(t.numel() for _, t in tree_lib.leaves(p)) == cfg.n_params()
    shapes = tree_lib.leaves(R.init_shapes(cfg),
                             lambda x: isinstance(x, tuple) and len(x) == 2
                             and tree_lib.is_shape(x[0]))
    assert [(path, tuple(t.shape)) for path, t in tree_lib.leaves(p)] == \
        [(path, s[0]) for path, s in shapes]
    # the published configuration
    full = R.XDeepFMConfig("xdeepfm")
    jfull = JR.XDeepFMConfig("xdeepfm")
    assert full.total_vocab == jfull.total_vocab == 39_000_064
    assert full.n_params() == jfull.n_params()


def test_init_draws_the_reference_distribution():
    cfg = R.XDeepFMConfig("x", **{**SMALL, "vocab_per_field": 4000,
                                  "cin_layers": (64, 64),
                                  "mlp_layers": (256, 128)})
    got = R.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    want = jax.tree.map(np.asarray, JR.init_params(
        JR.XDeepFMConfig(**dataclasses.asdict(cfg)),
        jax.random.key(0)))
    for (path, t), w in zip(tree_lib.leaves(got), jax.tree.leaves(want)):
        x = t.double().numpy()
        assert x.shape == w.shape and t.dtype == torch.float32, path
        if not w.any():
            assert not x.any(), path
            continue
        scale = 0.01 if path == ("table",) else 1 / np.sqrt(x.shape[0])
        z = x / scale
        tol = 6.0 / np.sqrt(z.size)
        assert abs(z.mean()) < tol and abs(z.std() - 1.0) < tol, (
            path, z.mean(), z.std())
