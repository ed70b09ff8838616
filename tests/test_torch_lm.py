"""The port's LM modules against the reference's, on carried weights.

* ``repro_torch.models.layers``: each function against ``repro.models.
  layers`` on the same numpy inputs (rtol 1e-5, atol 1e-6): rms_norm,
  rope, softcap, embeddings and the LM head; attention with and without
  the cache, a window shorter than the sequence, a softcap, GQA, MQA and
  an explicit mask; both MLP styles; ``moe_block`` on batches where
  experts overflow their capacity, with and without shared experts.
* ``repro_torch.configs``: the five architectures field for field, the
  parameter counts, the LM half of ``tests/test_arch_smoke.py::
  test_full_configs_match_assignment``, the 15 prefill and decode smoke
  cells through ``LMArch.build(...).fn`` on the reference's concrete
  arguments, and the unported names raising with their slice (the train
  cells are ``tests/test_torch_train_cells.py``'s).

The whole models are held in ``tests/test_torch_lm_model.py``. This
file also holds the helpers of the port's LM tests (configs and weights
carried from the reference to the port, and the whole-model tolerance),
which ``test_torch_lm_model.py`` and ``test_torch_serve_engine.py``
import.

Whole-model outputs (logits, KV caches) are held within ``SCALE_TOL`` of
each tensor's largest magnitude, besides rtol 1e-5. Elementwise rtol 1e-5,
atol 1e-5 is below f32's own spread on these models: the reference's
scan and unrolled layer loops (``TransformerConfig(unroll=True)``)
disagree with each other by up to 47 times that tolerance on the smoke
configs' caches, and by up to 3.7e-5 of a tensor's scale; the port
disagrees with the reference by up to 5e-5 of the scale. Each layer
function alone is held elementwise (rtol 1e-5, atol 1e-6).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as JARCHS
from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.models import layers as JL
from repro.models import transformer as JT
from repro_torch.configs import ARCHS, all_cells, get_arch
from repro_torch.configs import base
from repro_torch.models import layers as L
from repro_torch.models import transformer as T

SCALE_TOL = 1e-4  # of a whole model's output, on its largest magnitude
LM_IDS = ["gemma2-27b", "command-r-plus-104b", "granite-34b",
          "moonshot-v1-16b-a3b", "qwen3-moe-235b-a22b"]


def port_cfg(jcfg) -> T.TransformerConfig:
    """The port's ``TransformerConfig`` of a reference one (float32)."""
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(T.TransformerConfig)
          if f.name not in ("dtype", "moe")}
    moe = None if jcfg.moe is None else L.MoeConfig(
        **dataclasses.asdict(jcfg.moe))
    return T.TransformerConfig(**kw, moe=moe)


def reference_params(jcfg, seed: int):
    """The reference's ``init_params`` under ``jax.jit`` (a third of the
    time of its eager form on the smoke configs; the weights differ from
    the eager ones in the last place, and every test carries whichever it
    drew)."""
    return jax.jit(functools.partial(JT.init_params, jcfg))(
        jax.random.key(seed))


def carry(jcfg, jparams, device="cpu") -> T.Transformer:
    """The reference's weights in a port model."""
    return T.params_from_reference(port_cfg(jcfg),
                                   jax.tree.map(np.asarray, jparams), device)


def close(got, want, what: str) -> None:
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=SCALE_TOL * float(np.abs(want).max()),
                               err_msg=what)


def near_tie(logits: np.ndarray, a: int, b: int, tol: float) -> bool:
    """Whether tokens ``a`` and ``b`` are within ``tol`` in ``logits``."""
    return abs(float(logits[a]) - float(logits[b])) <= tol


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _same(got: torch.Tensor, want, what: str = "") -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               rtol=1e-5, atol=1e-6, err_msg=what)


# ---------------------------------------------------------------------------
# layers.py
# ---------------------------------------------------------------------------


def test_norm_rope_softcap_embed_head_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 12, 3, 16)).astype(np.float32)
    scale = rng.standard_normal(16).astype(np.float32) * 0.1
    for zc in (True, False):
        _same(L.rms_norm(_t(x), _t(scale), zero_centered=zc),
              JL.rms_norm(jnp.asarray(x), jnp.asarray(scale),
                          zero_centered=zc), f"rms_norm zc={zc}")
    pos = np.stack([np.arange(12), np.arange(12) + 40])
    for theta in (10000.0, 75000.0):
        _same(L.rope(_t(x), _t(pos), theta),
              JL.rope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), theta),
              f"rope {theta}")
    # rope rotates split halves: position 0 is the identity
    _same(L.rope(_t(x[:, :1]), torch.zeros(2, 1, dtype=torch.long)), x[:, :1])
    big = 40 * x
    for cap in (None, 50.0, 3.0):
        _same(L.softcap(_t(big), cap), JL.softcap(jnp.asarray(big), cap),
              f"softcap {cap}")
    p = {"embedding": rng.standard_normal((50, 16)).astype(np.float32),
         "lm_head": rng.standard_normal((16, 50)).astype(np.float32)}
    tp = {k: _t(v) for k, v in p.items()}
    toks = rng.integers(0, 50, (2, 7))
    for s in (False, True):
        _same(L.embed_tokens(tp, _t(toks), scale=s),
              JL.embed_tokens(p, jnp.asarray(toks), scale=s))
    h = rng.standard_normal((2, 7, 16)).astype(np.float32)
    for tied in (True, False):
        for cap in (None, 2.0):
            _same(L.lm_logits(tp, _t(h), cap=cap, tied=tied),
                  JL.lm_logits(p, jnp.asarray(h), cap=cap, tied=tied),
                  f"lm_logits tied={tied} cap={cap}")


ATTN_CASES = {
    # name: (H, K, window, softcap, query_scale, cache, mask)
    "gqa": (4, 2, None, None, None, None, False),
    "window": (4, 2, 5, None, None, None, False),
    "softcap": (4, 2, None, 2.0, None, None, False),
    "mqa": (6, 1, None, None, 0.3, None, False),
    "mha_mask": (4, 4, None, None, None, None, True),
    "cache_prefill": (4, 2, 5, 2.0, None, "prefill", False),
    "cache_decode": (4, 2, None, None, None, "decode", True),
    "mqa_cache_decode": (6, 1, 7, 2.0, None, "decode", False),
}


@pytest.mark.parametrize("case", list(ATTN_CASES))
def test_attention_matches_reference(case):
    H, K, window, cap, qs, cache, use_mask = ATTN_CASES[case]
    B, S, d, hd, T_max = 2, 12, 32, 8, 20
    rng = np.random.default_rng(1)
    p = {"wq": rng.standard_normal((d, H, hd)),
         "wk": rng.standard_normal((d, K, hd)),
         "wv": rng.standard_normal((d, K, hd)),
         "wo": rng.standard_normal((H * hd, d))}
    p = {k: (v / np.sqrt(d)).astype(np.float32) for k, v in p.items()}
    cfg_kw = dict(attn_softcap=cap, window=window, query_scale=qs)
    jcfg = JL.AttnConfig(H, K, hd, **cfg_kw)
    tcfg = L.AttnConfig(H, K, hd, **cfg_kw)
    if cache == "decode":
        S, pos0 = 1, 9
        positions = np.full((B, 1), pos0)
    else:
        pos0 = 0
        positions = np.broadcast_to(np.arange(S), (B, S)).copy()
    x = rng.standard_normal((B, S, d)).astype(np.float32)
    T_kv = T_max if cache else S
    mask = None
    if use_mask:  # the block's window mask form, with some keys cut
        mask = rng.random((B, S, T_kv)) < 0.8
        mask[..., 0] = True
    kw_j, kw_t = {}, {}
    if mask is not None:
        kw_j["mask"], kw_t["mask"] = jnp.asarray(mask), _t(mask)
    if cache:
        ck = rng.standard_normal((B, T_max, K, hd)).astype(np.float32)
        cv = rng.standard_normal((B, T_max, K, hd)).astype(np.float32)
        kw_j.update(kv_cache=(jnp.asarray(ck), jnp.asarray(cv)),
                    cache_pos=jnp.int32(pos0))
        kw_t.update(kv_cache=(_t(ck), _t(cv)), cache_pos=pos0)
    want, wcache = JL.attention(jcfg, p, jnp.asarray(x),
                                jnp.asarray(positions, jnp.int32), **kw_j)
    got, gcache = L.attention(tcfg, {k: _t(v) for k, v in p.items()}, _t(x),
                              _t(positions), **kw_t)
    _same(got, want, case)
    if cache:
        for g, w in zip(gcache, wcache):
            _same(g, w, f"{case} cache")
        assert gcache[0] is kw_t["kv_cache"][0]  # written in place
    else:
        assert gcache is None and wcache is None


def test_attention_cache_write_past_the_end_raises():
    cfg = L.AttnConfig(2, 1, 4)
    p = {"wq": torch.zeros(8, 2, 4), "wk": torch.zeros(8, 1, 4),
         "wv": torch.zeros(8, 1, 4), "wo": torch.zeros(8, 8)}
    cache = (torch.zeros(1, 6, 1, 4), torch.zeros(1, 6, 1, 4))
    with pytest.raises(ValueError, match="does not fit"):
        L.attention(cfg, p, torch.zeros(1, 3, 8),
                    torch.arange(3)[None] + 4, kv_cache=cache, cache_pos=4)


@pytest.mark.parametrize("style,act", [("gated", "silu"), ("gated", "gelu"),
                                       ("plain", "gelu"), ("plain", "relu")])
def test_mlp_matches_reference(style, act):
    rng = np.random.default_rng(2)
    d, f = 24, 40
    p = {"w_gate": rng.standard_normal((d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((f, d)) / np.sqrt(f)}
    if style == "plain":
        del p["w_gate"]
    p = {k: v.astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 9, d)).astype(np.float32)
    _same(L.gated_mlp(L.MlpConfig(f, act, style),
                      {k: _t(v) for k, v in p.items()}, _t(x)),
          JL.gated_mlp(JL.MlpConfig(f, act, style), p, jnp.asarray(x)))


MOE_CASES = {
    "shared": dict(n_shared=1, d_ff_shared=24),
    "routed_only": dict(),
    "softcap_gelu": dict(router_softcap=2.0, act="gelu", n_shared=2),
}


@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_block_matches_reference_with_capacity_drops(case):
    E, K, d, f = 8, 2, 16, 32
    kw = dict(n_experts=E, top_k=K, d_ff=f, **MOE_CASES[case])
    rng = np.random.default_rng(3)
    p = {"router": rng.standard_normal((d, E)) / np.sqrt(d),
         "w_gate": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_up": rng.standard_normal((E, d, f)) / np.sqrt(d),
         "w_down": rng.standard_normal((E, f, d)) / np.sqrt(f)}
    p["router"][:, 0] += 0.5  # a popular expert overflows its capacity
    if kw.get("n_shared"):
        dsh = kw.get("d_ff_shared") or f
        p["shared"] = {"w_gate": rng.standard_normal((d, dsh)) / np.sqrt(d),
                       "w_up": rng.standard_normal((d, dsh)) / np.sqrt(d),
                       "w_down": rng.standard_normal((dsh, d)) / np.sqrt(dsh)}
    p = jax.tree.map(lambda a: a.astype(np.float32), p)
    x = rng.standard_normal((2, 32, d)).astype(np.float32)
    jcfg = JL.MoeConfig(**kw)
    # the reference's own routing: some expert takes more than cap tokens
    logits = JL.softcap(jnp.asarray(x.reshape(-1, d)) @ p["router"],
                        jcfg.router_softcap)
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), K)
    cap = max(int(np.ceil(64 * K / E * jcfg.capacity_factor)), 4)
    assert np.bincount(np.asarray(top_e).ravel(), minlength=E).max() > cap
    want = JL.moe_block(jcfg, p, jnp.asarray(x))
    got = L.moe_block(L.MoeConfig(**kw), jax.tree.map(_t, p), _t(x))
    _same(got, want, case)


def test_configs_match_reference_field_for_field():
    fields = [f.name for f in dataclasses.fields(T.TransformerConfig)]
    for arch in LM_IDS:
        for smoke in (False, True):
            jc = jget_arch(arch).config(smoke=smoke)
            tc = get_arch(arch).config(smoke=smoke)
            for name in fields:
                got, want = getattr(tc, name), getattr(jc, name)
                if name == "dtype":
                    assert got == torch.float32 and want == jnp.float32
                elif name == "moe":
                    assert (got is None) == (want is None), arch
                    if got is not None:
                        assert dataclasses.asdict(got) == \
                            dataclasses.asdict(want)
                else:
                    assert got == want, (arch, smoke, name)
            # the reference's fields the port has no use for stay default
            assert jc.moe_every == 1 and jc.unroll is False
            np.testing.assert_array_equal(tc.layer_windows(),
                                          jc.layer_windows())
            assert tc.hd == jc.hd
            assert dataclasses.asdict(tc.attn) == dataclasses.asdict(jc.attn)
            assert dataclasses.asdict(tc.mlp) == dataclasses.asdict(jc.mlp)
            assert tc.n_params() == jc.n_params()
            assert tc.n_active_params() == jc.n_active_params()


def test_full_configs_match_assignment():
    """The LM half of ``tests/test_arch_smoke.py``'s spot-check."""
    g = get_arch("gemma2-27b").config()
    assert (g.n_layers, g.d_model, g.n_heads, g.n_kv, g.d_ff, g.vocab) == \
        (46, 4608, 32, 16, 36864, 256000)
    c = get_arch("command-r-plus-104b").config()
    assert (c.n_layers, c.d_model, c.n_heads, c.n_kv, c.vocab) == \
        (64, 12288, 96, 8, 256000)
    gr = get_arch("granite-34b").config()
    assert (gr.n_layers, gr.d_model, gr.n_heads, gr.n_kv) == (88, 6144, 48, 1)
    m = get_arch("moonshot-v1-16b-a3b").config()
    assert (m.moe.n_experts, m.moe.top_k, m.vocab) == (64, 6, 163840)
    q = get_arch("qwen3-moe-235b-a22b").config()
    assert (q.n_layers, q.moe.n_experts, q.moe.top_k) == (94, 128, 8)
    assert 20e9 < g.n_params() < 35e9
    assert 90e9 < c.n_params() < 120e9
    assert 25e9 < gr.n_params() < 42e9
    assert 200e9 < q.n_params() < 260e9
    assert 15e9 < q.n_active_params() < 30e9
    # the chip's cell: gemma2-27b cut to 8 layers
    g8 = dataclasses.replace(g, n_layers=8)
    assert g8.n_params() == 5_709_648_384
    assert g.n_params() - g8.n_params() == 38 * 566_249_472


def test_registry_and_cells_match_reference():
    assert set(ARCHS) == set(LM_IDS) == {
        a for a, s in JARCHS.items() if s.family == "lm"}
    assert all_cells() == [(a, s) for a in ARCHS for s in ARCHS[a].cells()]
    for ours, theirs in ((base.LM_CELLS, jbase.LM_CELLS),
                         (base.LM_SMOKE_CELLS, jbase.LM_SMOKE_CELLS)):
        assert {k: dataclasses.asdict(v) for k, v in ours.items()} == \
            {k: dataclasses.asdict(v) for k, v in theirs.items()}


SMOKE_CELLS = [(a, s) for a in LM_IDS for s, c in jbase.LM_SMOKE_CELLS.items()
               if c.kind in ("prefill", "decode")]


@pytest.mark.parametrize("arch,shape", SMOKE_CELLS,
                         ids=[f"{a}::{s}" for a, s in SMOKE_CELLS])
def test_smoke_cell_matches_reference(arch, shape):
    """``LMArch.build(cell, smoke=True).fn`` on the reference bundle's
    concrete arguments (weights carried, the cache copied) gives the
    reference's logits and cache."""
    jspec, spec = jget_arch(arch), get_arch(arch)
    jb = jspec.build(jspec.cells()[shape], smoke=True)
    tb = spec.build(spec.cells()[shape], smoke=True)
    assert tb.trip_counts == jb.trip_counts
    assert tb.model_flops == jb.model_flops
    args = jb.concrete_args(jax.random.key(42))
    want_logits, want_cache = jb.fn(*args)
    model = carry(jspec.config(smoke=True), args[0])
    targs = [model, _t(args[1]).long()]
    if len(args) == 4:
        targs.append(int(args[2]))
    targs.append(tuple(_t(c) for c in args[-1]))
    got = tb.fn(*targs)
    tb.check(got)
    logits, cache = got
    close(logits, want_logits, "logits")
    close(cache[0], want_cache[0], "k")
    close(cache[1], want_cache[1], "v")


def test_smoke_cell_concrete_args_run():
    """The port's own concrete arguments, from a torch generator."""
    spec = get_arch("moonshot-v1-16b-a3b")
    for shape in ("prefill_32k", "decode_32k"):
        b = spec.build(spec.cells()[shape], smoke=True, layers_override=2)
        args = b.concrete_args(torch.Generator().manual_seed(0), "cpu")
        assert len(args[0].layers) == 2
        b.check(b.fn(*args))


def test_unported_names_raise_with_their_slice():
    for arch, sl in (("gcn-cora", "7c"), ("gin-tu", "7c"), ("nequip", "7c"),
                     ("gat-cora", "7c"), ("xdeepfm", "7c"),
                     ("mfbc_paper", "7d")):
        assert arch in JARCHS
        with pytest.raises(NotImplementedError, match=f"slice {sl}"):
            get_arch(arch)
    with pytest.raises(KeyError, match="unknown arch"):
        get_arch("no-such-arch")
    # the train cells are ported (slice 7b): the gemma2 smoke cell runs
    # on its own concrete arguments
    spec = get_arch("gemma2-27b")
    b = spec.build(spec.cells()["train_4k"], smoke=True)
    args = b.concrete_args(torch.Generator().manual_seed(0), "cpu")
    b.check(b.fn(*args))
