"""The port's transformer against the reference's, on carried weights.

* ``forward``, ``prefill`` (logits, both caches) and ``decode_step`` of
  ``repro_torch.models.transformer`` on all five smoke configs against
  ``repro.models.transformer``, weights carried by
  ``params_from_reference`` (held as ``test_torch_lm.close`` says);
* ``params_to_numpy`` ∘ ``params_from_reference`` is bitwise;
* the port's own ``init_params`` draws the reference's distribution.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.models import transformer as JT
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T

from test_torch_lm import LM_IDS, carry, close, port_cfg, reference_params


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", LM_IDS)
def test_model_matches_reference(arch):
    """forward, prefill (the last logits, both caches) and two decode
    steps on the prefilled cache. The prompt (24) is longer than
    gemma2-smoke's window (16)."""
    jcfg = jget_arch(arch).config(smoke=True)
    params = reference_params(jcfg, 0)
    model = carry(jcfg, params)
    B, S, M = 2, 24, 28
    toks = np.random.default_rng(4).integers(0, jcfg.vocab, (B, S))
    close(T.forward(model, _t(toks)),
          JT.forward(jcfg, params, jnp.asarray(toks, jnp.int32)), "forward")
    jlog, jcache = JT.prefill(jcfg, params, jnp.asarray(toks, jnp.int32),
                              JT.init_cache(jcfg, B, M))
    tlog, tcache = T.prefill(model, _t(toks),
                             T.init_cache(model.cfg, B, M, device="cpu"))
    close(tlog, jlog, "prefill logits")
    close(tcache[0], jcache[0], "prefill k")
    close(tcache[1], jcache[1], "prefill v")
    tok = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None]
    for pos in (S, S + 1):
        jlog, jcache = JT.decode_step(jcfg, params,
                                      jnp.asarray(tok, jnp.int32),
                                      jnp.int32(pos), jcache)
        tlog, tcache = T.decode_step(model, _t(tok), pos, tcache)
        close(tlog, jlog, f"decode logits at {pos}")
        close(tcache[0], jcache[0], f"decode k at {pos}")
        close(tcache[1], jcache[1], f"decode v at {pos}")
        tok = np.argmax(np.asarray(jlog)[:, -1], -1)[:, None]


@pytest.mark.parametrize("arch", LM_IDS)
def test_params_round_trip_bitwise(arch):
    jcfg = jget_arch(arch).config(smoke=True)
    tree = jax.tree.map(np.asarray, reference_params(jcfg, 7))
    model = T.params_from_reference(port_cfg(jcfg), tree, "cpu")
    back = T.params_to_numpy(model)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    # a layer's parameter is the stacked leaf's slice
    np.testing.assert_array_equal(
        model.layers[1].attn.wq.numpy(), tree["layers"]["attn"]["wq"][1])
    n = sum(p.numel() for p in model.parameters())
    assert n == jcfg.n_params() and not any(
        p.requires_grad for p in model.parameters())
    bad = dict(tree, embedding=tree["embedding"][:-1])
    with pytest.raises(ValueError, match="embedding"):
        T.params_from_reference(port_cfg(jcfg), bad, "cpu")


def test_init_params_draws_the_reference_distribution():
    """Normal × 1/sqrt(fan_in) with fan_in = shape[-2] of the stacked
    shape (the head count for wq/wk/wv), norm scales zero."""
    cfg = get_arch("gemma2-27b").config(smoke=True)
    model = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    again = T.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    for (n, a), (_, b) in zip(model.named_parameters(),
                              again.named_parameters()):
        assert torch.equal(a, b), n
    tree = T.params_to_numpy(model)
    L_ = tree["layers"]
    for path in (("final_norm", "scale"), ("layers", "norm_attn", "scale"),
                 ("layers", "norm_mlp_post", "scale")):
        leaf = tree
        for k in path:
            leaf = leaf[k]
        assert not np.any(leaf), path
    for leaf, fan_in in ((L_["attn"]["wq"], cfg.n_heads),
                         (L_["attn"]["wk"], cfg.n_kv),
                         (L_["attn"]["wo"], cfg.n_heads * cfg.hd),
                         (L_["mlp"]["w_down"], cfg.d_ff),
                         (L_["mlp"]["w_gate"], cfg.d_model),
                         (tree["embedding"], cfg.vocab)):
        np.testing.assert_allclose(leaf.std(), fan_in ** -0.5, rtol=0.05)


