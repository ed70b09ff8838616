"""Decoder-only LM family: dense (gemma2 / command-r / granite) and MoE
(moonshot / qwen3) variants.

A port of the serving half of ``repro/models/transformer.py``. Supports
three block styles:
  * ``prenorm``  — llama-style sequential pre-norm (granite, qwen3, moonshot)
  * ``sandwich`` — gemma2 pre+post norms around both sublayers
  * ``parallel`` — command-r parallel attention+MLP with one input norm

plus per-layer sliding windows (gemma2 alternating local/global), logit
softcaps, GQA, tied embeddings, and capacity-based MoE.

A model is a ``Transformer`` module: the embedding (and untied
``lm_head``), ``final_norm`` and one ``Block`` module a layer, whose
parameter names are the reference tree's paths (``layers.3.attn.wq`` is
``params["layers"]["attn"]["wq"][3]``). Entry points:
  * ``init_params(cfg, generator, device)``     — a model with drawn weights
  * ``params_from_reference(cfg, tree, device)`` / ``params_to_numpy(model)``
    — weights from and to the reference's tree (layers stacked on dim 0)
  * ``forward(model, tokens)`` / ``forward_hidden`` — logits / hidden states
  * ``init_cache`` / ``prefill`` / ``decode_step`` — serving

The cache is written in place (the reference returns an updated copy);
``prefill`` and ``decode_step`` return the same tensors. Training
(``loss_fn``) is slice 7b; the sharding helpers (``abstract_params``,
``param_logical_axes``, ``cache_abstract``) have no counterpart without a
mesh of the LM.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.models import layers as L

Params = Dict[str, Any]
GLOBAL = 1 << 30  # the window of a global layer


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: Optional[int] = None  # default d_model // n_heads
    block_style: str = "prenorm"  # prenorm | sandwich | parallel
    mlp_style: str = "gated"  # gated | plain
    act: str = "silu"
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None
    final_softcap: Optional[float] = None
    query_scale: Optional[float] = None
    tie_embeddings: bool = True
    scale_embeddings: bool = False
    window_pattern: Optional[Tuple[Optional[int], ...]] = None  # cycle per layer
    # MoE (None -> dense)
    moe: Optional[L.MoeConfig] = None
    dtype: torch.dtype = torch.float32
    remat: str = "none"  # none | full | dots (read by training, slice 7b)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def attn(self) -> L.AttnConfig:
        return L.AttnConfig(self.n_heads, self.n_kv, self.hd,
                            rope_theta=self.rope_theta,
                            attn_softcap=self.attn_softcap,
                            query_scale=self.query_scale)

    @property
    def mlp(self) -> L.MlpConfig:
        return L.MlpConfig(self.d_ff, self.act, self.mlp_style)

    def layer_windows(self) -> np.ndarray:
        """(L,) int32 per-layer window (``GLOBAL`` = global)."""
        if self.window_pattern is None:
            return np.full(self.n_layers, GLOBAL, np.int32)
        pat = [w if w is not None else GLOBAL for w in self.window_pattern]
        return np.asarray([pat[l % len(pat)] for l in range(self.n_layers)],
                          np.int32)

    def n_params(self) -> int:
        """Analytic parameter count."""
        d, hd = self.d_model, self.hd
        attn = d * hd * (self.n_heads + 2 * self.n_kv) + self.n_heads * hd * d
        if self.moe is not None:
            ff = 3 * d * self.moe.d_ff * self.moe.n_experts + d * self.moe.n_experts
            if self.moe.n_shared:
                ff += 3 * d * (self.moe.d_ff_shared or self.moe.d_ff)
        else:
            mats = 2 if self.mlp_style == "plain" else 3
            ff = mats * d * self.d_ff
        norms = 4 * d if self.block_style == "sandwich" else 2 * d
        per_layer = attn + ff + norms
        emb = self.vocab * d * (1 if self.tie_embeddings else 2)
        return self.n_layers * per_layer + emb + d

    def n_active_params(self) -> int:
        if self.moe is None:
            return self.n_params()
        d = self.d_model
        dense = self.n_params() - self.n_layers * 3 * d * self.moe.d_ff * \
            self.moe.n_experts
        act_ff = self.n_layers * 3 * d * self.moe.d_ff * self.moe.top_k
        return dense + act_ff


# ---------------------------------------------------------------------------
# Parameter trees.
# ---------------------------------------------------------------------------


def _layer_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    d, hd = cfg.d_model, cfg.hd
    shapes = {
        "attn": {
            "wq": (d, cfg.n_heads, hd),
            "wk": (d, cfg.n_kv, hd),
            "wv": (d, cfg.n_kv, hd),
            "wo": (cfg.n_heads * hd, d),
        },
        "norm_attn": {"scale": (d,)},
        "norm_mlp": {"scale": (d,)},
    }
    if cfg.block_style == "sandwich":
        shapes["norm_attn_post"] = {"scale": (d,)}
        shapes["norm_mlp_post"] = {"scale": (d,)}
    if cfg.moe is not None:
        m = cfg.moe
        shapes["moe"] = {
            "router": (d, m.n_experts),
            "w_gate": (m.n_experts, d, m.d_ff),
            "w_up": (m.n_experts, d, m.d_ff),
            "w_down": (m.n_experts, m.d_ff, d),
        }
        if m.n_shared:
            dsh = m.d_ff_shared or m.d_ff
            shapes["moe"]["shared"] = {"w_gate": (d, dsh), "w_up": (d, dsh),
                                       "w_down": (dsh, d)}
    elif cfg.mlp_style == "plain":
        shapes["mlp"] = {"w_up": (d, cfg.d_ff), "w_down": (cfg.d_ff, d)}
    else:
        shapes["mlp"] = {"w_gate": (d, cfg.d_ff), "w_up": (d, cfg.d_ff),
                         "w_down": (cfg.d_ff, d)}
    return shapes


def _stack(shapes: Dict[str, Any], n: int) -> Dict[str, Any]:
    return {k: _stack(v, n) if isinstance(v, dict) else (n,) + v
            for k, v in shapes.items()}


def param_shapes(cfg: TransformerConfig) -> Dict[str, Any]:
    """The reference's parameter tree of shapes, layers stacked on dim 0."""
    tree = {
        "embedding": (cfg.vocab, cfg.d_model),
        "final_norm": {"scale": (cfg.d_model,)},
        "layers": _stack(_layer_shapes(cfg), cfg.n_layers),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = (cfg.d_model, cfg.vocab)
    return tree


def _leaves(tree: Dict[str, Any], prefix: Tuple[str, ...] = ()
            ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) in sorted key order, the order ``jax.tree`` flattens
    a dict in."""
    for k in sorted(tree):
        if isinstance(tree[k], dict):
            yield from _leaves(tree[k], prefix + (k,))
        else:
            yield prefix + (k,), tree[k]


# ---------------------------------------------------------------------------
# Modules.
# ---------------------------------------------------------------------------


class Block(nn.Module):
    """One transformer layer. Its window acts only through the mask it
    passes to attention (``GLOBAL`` = global); the attention config's own
    ``window`` stays None."""

    def __init__(self, cfg: TransformerConfig, window: int, *,
                 device: torch.device):
        super().__init__()
        self.cfg = cfg
        self.window = int(window)
        shapes = _layer_shapes(cfg)
        kw = dict(dtype=cfg.dtype, device=device)
        self.attn = L.Attention(cfg.attn, shapes["attn"], **kw)
        self.norm_attn = L.RMSNorm(shapes["norm_attn"], **kw)
        self.norm_mlp = L.RMSNorm(shapes["norm_mlp"], **kw)
        if cfg.block_style == "sandwich":
            self.norm_attn_post = L.RMSNorm(shapes["norm_attn_post"], **kw)
            self.norm_mlp_post = L.RMSNorm(shapes["norm_mlp_post"], **kw)
        if cfg.moe is not None:
            self.moe = L.MoeBlock(cfg.moe, shapes["moe"], **kw)
        else:
            self.mlp = L.GatedMlp(cfg.mlp, shapes["mlp"], **kw)

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv_cache=None, cache_pos: Optional[int] = None):
        cfg = self.cfg
        q_pos = positions if positions.ndim > 1 else positions[None, :]
        T = kv_cache[0].shape[1] if kv_cache is not None else x.shape[1]
        kv_pos = torch.arange(T, device=x.device)
        wmask = kv_pos[None, None, :] > (q_pos[:, :, None] - self.window)
        ffn = self.mlp if cfg.moe is None else self.moe

        h = self.norm_attn(x)
        a, cache = self.attn(h, positions, mask=wmask, kv_cache=kv_cache,
                             cache_pos=cache_pos)
        if cfg.block_style == "parallel":
            return x + a + ffn(self.norm_mlp(x)), cache
        if cfg.block_style == "sandwich":
            a = self.norm_attn_post(a)
        x = x + a
        m = ffn(self.norm_mlp(x))
        if cfg.block_style == "sandwich":
            m = self.norm_mlp_post(m)
        return x + m, cache


class Transformer(nn.Module):
    """The LM's parameters (uninitialized: see ``init_params`` and
    ``params_from_reference``), on ``device``: the card by default."""

    def __init__(self, cfg: TransformerConfig, device="cuda"):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        kw = dict(dtype=cfg.dtype, device=dev)
        self.embedding = nn.Parameter(
            torch.empty(cfg.vocab, cfg.d_model, **kw), requires_grad=False)
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(
                torch.empty(cfg.d_model, cfg.vocab, **kw),
                requires_grad=False)
        self.final_norm = L.RMSNorm({"scale": (cfg.d_model,)}, **kw)
        self.layers = nn.ModuleList(
            Block(cfg, w, device=dev) for w in cfg.layer_windows())

    @property
    def device(self) -> torch.device:
        return self.embedding.device

    def head(self) -> Params:
        """``embedding`` (and ``lm_head``), as ``embed_tokens`` and
        ``lm_logits`` take them."""
        return dict(self._parameters)

    def forward(self, tokens: torch.Tensor) -> torch.Tensor:
        return forward(self, tokens)


def _targets(cfg: TransformerConfig, path: Tuple[str, ...]):
    """The model's parameter name(s) of one leaf of the reference tree:
    one a layer for a stacked leaf."""
    if path[0] == "layers":
        return [".".join(("layers", str(l)) + path[1:])
                for l in range(cfg.n_layers)]
    return [".".join(path)]


def _load(model: Transformer, path, value: torch.Tensor) -> None:
    names = _targets(model.cfg, path)
    with torch.no_grad():
        for i, name in enumerate(names):
            model.get_parameter(name).copy_(
                value[i] if path[0] == "layers" else value)


def _is_norm_scale(cfg: TransformerConfig, shape) -> bool:
    # the reference's rule on the stacked shapes: (d,) or (L, d)
    return shape[-1] == cfg.d_model and (
        len(shape) == 1 or (len(shape) == 2 and shape[0] == cfg.n_layers))


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device="cuda") -> Transformer:
    """A model whose weights are drawn as the reference's ``init_params``
    draws them: each leaf of the stacked tree, in sorted key order,
    normal × 1/sqrt(fan_in) with fan_in = ``shape[-2]`` of the *stacked*
    shape (the head count for ``wq``/``wk``/``wv``); norm scales zero
    (zero-centered RMSNorm). The stream is ``generator``'s (drawn on its
    device, then moved to ``device``), not ``jax.random``'s: parity with
    the reference goes through ``params_from_reference``."""
    model = Transformer(cfg, device)
    for path, shape in _leaves(param_shapes(cfg)):
        if _is_norm_scale(cfg, shape):
            value = torch.zeros(shape, dtype=cfg.dtype)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            value = torch.randn(shape, generator=generator,
                                device=generator.device, dtype=cfg.dtype)
            value *= 1.0 / np.sqrt(max(fan_in, 1))
        _load(model, path, value)
    return model


def params_from_reference(cfg: TransformerConfig, tree: Params,
                          device="cuda") -> Transformer:
    """A model holding the reference's parameter tree (numpy arrays of
    ``cfg.dtype``, layers stacked on dim 0), bit for bit."""
    model = Transformer(cfg, device)
    want = torch.empty((), dtype=cfg.dtype).numpy().dtype
    for path, shape in _leaves(param_shapes(cfg)):
        arr = tree
        for k in path:
            arr = arr[k]
        arr = np.asarray(arr)
        if arr.shape != shape or arr.dtype != want:
            raise ValueError(f"{'/'.join(path)}: {arr.dtype}{arr.shape}, "
                             f"expected {want}{shape}")
        arr = np.require(arr, requirements="CW")  # copies a read-only array
        _load(model, path, torch.from_numpy(arr))
    return model


def params_to_numpy(model: Transformer) -> Params:
    """The reference's parameter tree of ``model``'s weights as numpy
    arrays (layers stacked on dim 0); the inverse of
    ``params_from_reference``."""
    out: Params = {}
    for path, _ in _leaves(param_shapes(model.cfg)):
        parts = [model.get_parameter(n).detach().cpu().numpy()
                 for n in _targets(model.cfg, path)]
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = np.stack(parts) if path[0] == "layers" else parts[0]
    return out


# ---------------------------------------------------------------------------
# Forward pass.
# ---------------------------------------------------------------------------


def forward_hidden(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """Forward pass up to (but excluding) the LM head: (B, S, d)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = L.embed_tokens(model.head(), tokens, scale=cfg.scale_embeddings)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for block in model.layers:
        x, _ = block(x, positions)
    return L.rms_norm(x, model.final_norm.scale)


def forward(model: Transformer, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, vocab)."""
    x = forward_hidden(model, tokens)
    return L.lm_logits(model.head(), x, cap=model.cfg.final_softcap,
                       tied=model.cfg.tie_embeddings)


# ---------------------------------------------------------------------------
# Serving: KV cache, prefill, decode.
# ---------------------------------------------------------------------------


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32, device="cuda"):
    """(k, v), each (n_layers, batch, max_len, n_kv, hd) zeros."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    dev = resolve_device(device)
    return (torch.zeros(shape, dtype=dtype, device=dev),
            torch.zeros(shape, dtype=dtype, device=dev))


def _layers_cached(model: Transformer, x, positions, cache, cache_pos: int):
    ck, cv = cache
    for l, block in enumerate(model.layers):
        x, _ = block(x, positions, kv_cache=(ck[l], cv[l]),
                     cache_pos=cache_pos)
    return x, (ck, cv)


def prefill(model: Transformer, tokens: torch.Tensor, cache):
    """Fill the cache with a prompt; returns (logits_last, cache)."""
    cfg = model.cfg
    B, S = tokens.shape
    x = L.embed_tokens(model.head(), tokens, scale=cfg.scale_embeddings)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    x, cache = _layers_cached(model, x, positions, cache, 0)
    x = L.rms_norm(x, model.final_norm.scale)
    logits = L.lm_logits(model.head(), x[:, -1:], cap=cfg.final_softcap,
                         tied=cfg.tie_embeddings)
    return logits, cache


def decode_step(model: Transformer, token: torch.Tensor, pos: int, cache):
    """One decode step. token: (B, 1) int; pos: the cache fill, the same
    for every row. Returns (logits (B, 1, V), cache)."""
    cfg = model.cfg
    B = token.shape[0]
    pos = int(pos)
    x = L.embed_tokens(model.head(), token, scale=cfg.scale_embeddings)
    positions = torch.full((B, 1), pos, dtype=torch.long,
                           device=token.device)
    x, cache = _layers_cached(model, x, positions, cache, pos)
    x = L.rms_norm(x, model.final_norm.scale)
    logits = L.lm_logits(model.head(), x, cap=cfg.final_softcap,
                         tied=cfg.tie_embeddings)
    return logits, cache
