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
  * ``init_tree(cfg, generator, device)``       — the same weights as the
    reference's tree of tensors (layers stacked on dim 0): a train state's
    parameters
  * ``params_from_reference(cfg, tree, device)`` / ``params_to_numpy(model)``
    — weights from and to the reference's tree (layers stacked on dim 0)
  * ``forward(model, tokens)`` / ``forward_hidden`` — logits / hidden states
  * ``loss_fn(model, tokens, targets, chunks=)`` — next-token cross entropy
  * ``init_cache`` / ``prefill`` / ``decode_step`` — serving

``forward``, ``forward_hidden`` and ``loss_fn`` take a ``Transformer`` or
a pair ``(cfg, tree)`` of a config and a stacked tree, which training
differentiates: each stacked leaf is unbound into its layers once a call.
``cfg.remat`` checkpoints the layers when autograd records: ``"full"``
keeps each layer's input only, ``"dots"`` the products' outputs
(``torch.utils.checkpoint``, non-reentrant; values never change).

The cache is written in place (the reference returns an updated copy);
``prefill`` and ``decode_step`` return the same tensors. The sharding
helpers (``abstract_params``, ``param_logical_axes``, ``cache_abstract``)
have no counterpart without a mesh of the LM.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
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
    remat: str = "none"  # none | full | dots: what a layer keeps for backward

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

    def tree(self) -> Params:
        """The layer's parameters as the reference's nested dict."""
        return {k: m.tree() for k, m in self._modules.items()}

    def forward(self, x: torch.Tensor, positions: torch.Tensor,
                kv_cache=None, cache_pos: Optional[int] = None):
        return block(self.cfg, self.window, self.tree(), x, positions,
                     kv_cache=kv_cache, cache_pos=cache_pos)


def block(cfg: TransformerConfig, window: int, lp: Params, x: torch.Tensor,
          positions: torch.Tensor, kv_cache=None,
          cache_pos: Optional[int] = None):
    """One layer on its parameters ``lp`` (the reference's layer tree);
    returns (out, cache)."""
    q_pos = positions if positions.ndim > 1 else positions[None, :]
    T = kv_cache[0].shape[1] if kv_cache is not None else x.shape[1]
    kv_pos = torch.arange(T, device=x.device)
    wmask = kv_pos[None, None, :] > (q_pos[:, :, None] - window)

    def ffn(h):
        if cfg.moe is None:
            return L.gated_mlp(cfg.mlp, lp["mlp"], h)
        return L.moe_block(cfg.moe, lp["moe"], h)

    h = L.rms_norm(x, lp["norm_attn"]["scale"])
    a, cache = L.attention(cfg.attn, lp["attn"], h, positions, mask=wmask,
                           kv_cache=kv_cache, cache_pos=cache_pos)
    if cfg.block_style == "parallel":
        return x + a + ffn(L.rms_norm(x, lp["norm_mlp"]["scale"])), cache
    if cfg.block_style == "sandwich":
        a = L.rms_norm(a, lp["norm_attn_post"]["scale"])
    x = x + a
    m = ffn(L.rms_norm(x, lp["norm_mlp"]["scale"]))
    if cfg.block_style == "sandwich":
        m = L.rms_norm(m, lp["norm_mlp_post"]["scale"])
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


def _draw(cfg: TransformerConfig, generator: torch.Generator):
    """(path, value) of each leaf of the stacked tree, in sorted key
    order, on ``generator``'s device."""
    for path, shape in tree_lib.leaves(param_shapes(cfg)):
        if _is_norm_scale(cfg, shape):
            value = torch.zeros(shape, dtype=cfg.dtype,
                                device=generator.device)
        else:
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            value = torch.randn(shape, generator=generator,
                                device=generator.device, dtype=cfg.dtype)
            value *= 1.0 / np.sqrt(max(fan_in, 1))
        yield path, value


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
    for path, value in _draw(cfg, generator):
        _load(model, path, value)
    return model


def init_tree(cfg: TransformerConfig, generator: torch.Generator,
              device="cuda") -> Params:
    """``init_params``'s weights (the same draws) as the reference's tree
    of tensors, layers stacked on dim 0, on ``device``."""
    dev = resolve_device(device)
    return tree_lib.unflatten((path, value.to(dev))
                              for path, value in _draw(cfg, generator))


def params_from_reference(cfg: TransformerConfig, tree: Params,
                          device="cuda") -> Transformer:
    """A model holding the reference's parameter tree (numpy arrays of
    ``cfg.dtype``, layers stacked on dim 0), bit for bit."""
    model = Transformer(cfg, device)
    want = torch.empty((), dtype=cfg.dtype).numpy().dtype
    for path, shape in tree_lib.leaves(param_shapes(cfg)):
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
    def leaf(path):
        parts = [model.get_parameter(n).detach().cpu().numpy()
                 for n in _targets(model.cfg, path)]
        return np.stack(parts) if path[0] == "layers" else parts[0]

    return tree_lib.unflatten((path, leaf(path)) for path, _ in
                              tree_lib.leaves(param_shapes(model.cfg)))


# ---------------------------------------------------------------------------
# Forward pass.
# ---------------------------------------------------------------------------


Model = Union[Transformer, Tuple[TransformerConfig, Params]]


@dataclasses.dataclass
class _Parts:
    """A model's parameters as the forward pass reads them."""
    cfg: TransformerConfig
    head: Params  # embedding (and lm_head)
    final_scale: torch.Tensor
    layers: List[Tuple[int, Params]]  # (window, layer tree) a layer


def _unstack(stacked: Params, n: int) -> List[Params]:
    """A stacked layer tree as ``n`` layer trees: each leaf unbound once
    (one backward stacks its gradient; an index a layer would allocate a
    full-size zero gradient a layer)."""
    out: List[Params] = [{} for _ in range(n)]
    for k, v in stacked.items():
        parts = _unstack(v, n) if isinstance(v, dict) else v.unbind(0)
        for l in range(n):
            out[l][k] = parts[l]
    return out


def _parts(model: Model) -> _Parts:
    if isinstance(model, Transformer):
        return _Parts(model.cfg, model.head(), model.final_norm.scale,
                      [(b.window, b.tree()) for b in model.layers])
    cfg, tree = model
    head = {k: tree[k] for k in ("embedding", "lm_head") if k in tree}
    windows = cfg.layer_windows().tolist()
    return _Parts(cfg, head, tree["final_norm"]["scale"],
                  list(zip(windows, _unstack(tree["layers"], cfg.n_layers))))


def _dots_policy(ctx, op, *args, **kwargs):
    """``remat="dots"``: keep the products without batch dimensions (the
    reference's ``checkpoint_dots_with_no_batch_dims``). ``torch.einsum``
    and ``@`` reach aten as ``mm`` or as a ``bmm`` of batch 1 when no
    operand dimension is batched (the projections, MLPs, router, head),
    and as a ``bmm`` of batch > 1 when one is (attention's per-(b, kv
    head) products, the MoE's per-expert products): those recompute."""
    aten = torch.ops.aten
    if op is aten.mm.default or (op is aten.bmm.default
                                 and args[0].shape[0] == 1):
        return ckpt.CheckpointPolicy.MUST_SAVE
    return ckpt.CheckpointPolicy.PREFER_RECOMPUTE


def _remat(cfg: TransformerConfig, fn, *args):
    """``fn(*args)`` under ``cfg.remat`` when autograd records."""
    if cfg.remat == "none" or not torch.is_grad_enabled():
        return fn(*args)
    kw = {}
    if cfg.remat == "dots":
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, _dots_policy)
    elif cfg.remat != "full":
        raise ValueError(f"remat {cfg.remat!r} (none | full | dots)")
    return ckpt.checkpoint(fn, *args, use_reentrant=False, **kw)


def _layer(cfg, window, lp, x, positions):
    return block(cfg, window, lp, x, positions)[0]


def forward_hidden(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    """Forward pass up to (but excluding) the LM head: (B, S, d)."""
    return _hidden(_parts(model), tokens)


def _hidden(p: _Parts, tokens: torch.Tensor) -> torch.Tensor:
    cfg = p.cfg
    B, S = tokens.shape
    x = L.embed_tokens(p.head, tokens, scale=cfg.scale_embeddings)
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for window, lp in p.layers:
        # the layer's parameters are closed over, so a recompute in the
        # backward reads the same tensors
        x = _remat(cfg, functools.partial(_layer, cfg, window, lp), x,
                   positions)
    return L.rms_norm(x, p.final_scale)


def forward(model: Model, tokens: torch.Tensor) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, vocab)."""
    p = _parts(model)
    return L.lm_logits(p.head, _hidden(p, tokens), cap=p.cfg.final_softcap,
                       tied=p.cfg.tie_embeddings)


def _chunk_loss(hx, tx, w, cap):
    logits = L.softcap(torch.einsum("bsd,dv->bsv", hx, w), cap).float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, tx[..., None])[..., 0]
    return torch.sum(logz - gold)


def loss_fn(model: Model, tokens: torch.Tensor, targets: torch.Tensor, *,
            chunks: int = 1) -> torch.Tensor:
    """Next-token cross entropy, a mean over the (B, S) targets.

    ``chunks > 1``: chunked CE — the (B, S, vocab) logits tensor is never
    materialized whole; each sequence chunk's logits are computed,
    consumed, and (in the backward, by ``torch.utils.checkpoint``)
    recomputed. The chunk sums add in chunk order, as the reference's
    scan does.
    """
    targets = targets.long()
    if chunks <= 1:
        logits = forward(model, tokens).float()
        logz = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, targets[..., None])[..., 0]
        return torch.mean(logz - gold)

    p = _parts(model)
    cfg = p.cfg
    h = _hidden(p, tokens)
    B, S, D = h.shape
    assert S % chunks == 0, (S, chunks)
    hc = h.reshape(B, chunks, S // chunks, D).transpose(0, 1)
    tc = targets.reshape(B, chunks, S // chunks).transpose(0, 1)
    w = p.head["embedding"].T if cfg.tie_embeddings else p.head["lm_head"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(chunks):
        if torch.is_grad_enabled():
            part = ckpt.checkpoint(_chunk_loss, hc[i], tc[i], w,
                                   cfg.final_softcap, use_reentrant=False)
        else:
            part = _chunk_loss(hc[i], tc[i], w, cfg.final_softcap)
        total = total + part
    return total / (B * S)


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
