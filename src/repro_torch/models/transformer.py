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
``prefill`` and ``decode_step`` return the same tensors.

Sharding (``repro_torch.sharding``): ``param_logical_axes`` names each
parameter's logical axes, ``abstract_params`` / ``cache_abstract`` give
uninitialized (fake or meta) trees, DTensors placed by a policy with a
mesh. The entry points take ``policy`` (default ``NO_SHARDING``: no
effect) and constrain activations where the reference does: a layer's
output and the embedding to (batch, seq, ·), the logits to (batch, ·,
vocab), the MoE's expert buffers to (expert, batch, ·).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, List, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.models import layers as L
from repro_torch.sharding.rules import (NO_SHARDING, ShardingPolicy,
                                        abstract, place, replicate_over,
                                        scope)

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


def param_logical_axes(cfg: TransformerConfig, model_size: int = 1
                       ) -> Dict[str, Any]:
    """Logical sharding axes per parameter (layer dim first for stacks).

    KV heads shard over ``model`` only when divisible (GQA/MQA with few KV
    heads replicates them — the standard TP treatment); the KV *cache* then
    shards its sequence dim instead (see ``cache_abstract``).
    """
    kv_ax = "model" if model_size > 0 and cfg.n_kv % max(model_size, 1) == 0 \
        else None
    lax_ = {
        "attn": {
            "wq": (None, "fsdp", "model", None),
            "wk": (None, "fsdp", kv_ax, None),
            "wv": (None, "fsdp", kv_ax, None),
            "wo": (None, "model", "fsdp"),
        },
        "norm_attn": {"scale": (None, None)},
        "norm_mlp": {"scale": (None, None)},
    }
    if cfg.block_style == "sandwich":
        lax_["norm_attn_post"] = {"scale": (None, None)}
        lax_["norm_mlp_post"] = {"scale": (None, None)}
    if cfg.moe is not None:
        lax_["moe"] = {
            "router": (None, "fsdp", None),
            "w_gate": (None, "expert", "fsdp", None),
            "w_up": (None, "expert", "fsdp", None),
            "w_down": (None, "expert", None, "fsdp"),
        }
        if cfg.moe.n_shared:
            lax_["moe"]["shared"] = {"w_gate": (None, "fsdp", "model"),
                                     "w_up": (None, "fsdp", "model"),
                                     "w_down": (None, "model", "fsdp")}
    elif cfg.mlp_style == "plain":
        lax_["mlp"] = {"w_up": (None, "fsdp", "model"),
                       "w_down": (None, "model", "fsdp")}
    else:
        lax_["mlp"] = {"w_gate": (None, "fsdp", "model"),
                       "w_up": (None, "fsdp", "model"),
                       "w_down": (None, "model", "fsdp")}
    tree = {
        "embedding": ("vocab", "fsdp"),
        "final_norm": {"scale": (None,)},
        "layers": lax_,
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ("fsdp", "vocab")
    return tree


def _logical_at(logical: Params, path) -> Tuple:
    for k in path:
        logical = logical[k]
    return logical


def abstract_params(cfg: TransformerConfig,
                    policy: ShardingPolicy = NO_SHARDING, device="cpu"
                    ) -> Params:
    """The stacked parameter tree, uninitialized (``sharding.abstract``:
    fake under a ``FakeTensorMode``), each leaf placed by
    ``policy.named`` of its logical axes when the policy has a mesh."""
    logical = param_logical_axes(cfg, policy.model_size)
    return tree_lib.unflatten(
        (path, abstract(shape, cfg.dtype,
                        policy.named(_logical_at(logical, path)), device))
        for path, shape in tree_lib.leaves(param_shapes(cfg),
                                           tree_lib.is_shape))


def place_params(cfg: TransformerConfig, tree: Params,
                 policy: ShardingPolicy) -> Params:
    """A stacked parameter tree whose leaves are the same on every rank,
    as DTensors placed by ``policy.named`` of their logical axes (each
    rank keeps its shards; no collective). ``tree`` itself without a
    mesh."""
    if policy.mesh is None:
        return tree
    logical = param_logical_axes(cfg, policy.model_size)
    return tree_lib.unflatten(
        (path, place(t, policy.named(_logical_at(logical, path))))
        for path, t in tree_lib.leaves(tree))


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
                kv_cache=None, cache_pos: Optional[int] = None,
                policy: ShardingPolicy = NO_SHARDING):
        return block(self.cfg, self.window, self.tree(), x, positions,
                     kv_cache=kv_cache, cache_pos=cache_pos, policy=policy)


def block(cfg: TransformerConfig, window: int, lp: Params, x: torch.Tensor,
          positions: torch.Tensor, kv_cache=None,
          cache_pos: Optional[int] = None,
          policy: ShardingPolicy = NO_SHARDING):
    """One layer on its parameters ``lp`` (the reference's layer tree);
    returns (out, cache), ``out`` constrained to (batch, seq, ·). Over
    DTensors whose layout allows it, the sublayers run per rank
    (``_block_tp``)."""
    if policy.mesh is not None:  # the layer's input layout
        x = policy.constrain(x, ("batch", "seq", None))
    if policy.mesh is not None and _tp_layout(cfg, x, kv_cache) is not None:
        a, ffn = _block_tp(cfg, window, lp, x, positions, kv_cache,
                           cache_pos, policy)
        cache = kv_cache
    else:
        def ffn(h):
            if cfg.moe is None:
                return L.gated_mlp(cfg.mlp, lp["mlp"], h)
            return L.moe_block(cfg.moe, lp["moe"], h, policy)

        T = kv_cache[0].shape[1] if kv_cache is not None else x.shape[1]
        h = L.rms_norm(x, lp["norm_attn"]["scale"])
        a, cache = L.attention(cfg.attn, lp["attn"], h, positions,
                               mask=_window_mask(positions, T, window),
                               kv_cache=kv_cache, cache_pos=cache_pos)
    out = _residual(cfg, lp, x, a, ffn)
    return policy.constrain(out, ("batch", "seq", None)), cache


def _window_mask(positions: torch.Tensor, T: int, window: int):
    """(B or 1, S, T): which of the ``T`` cache positions each query at
    ``positions`` sees through its window (causality is attention's)."""
    q_pos = positions if positions.ndim > 1 else positions[None, :]
    kv_pos = torch.arange(T, device=q_pos.device)
    return kv_pos[None, None, :] > (q_pos[:, :, None] - window)


def _residual(cfg: TransformerConfig, lp: Params, x, a, ffn):
    """The layer's residual and norm wiring (``block_style``) around its
    input ``x``, its attention output ``a`` and its feed-forward ``ffn``."""
    if cfg.block_style == "parallel":
        return x + a + ffn(L.rms_norm(x, lp["norm_mlp"]["scale"]))
    if cfg.block_style == "sandwich":
        a = L.rms_norm(a, lp["norm_attn_post"]["scale"])
    x = x + a
    m = ffn(L.rms_norm(x, lp["norm_mlp"]["scale"]))
    if cfg.block_style == "sandwich":
        m = L.rms_norm(m, lp["norm_mlp_post"]["scale"])
    return x + m


def _tp_layout(cfg: TransformerConfig, x, kv_cache):
    """The ``model`` mesh dim when ``x`` is a DTensor sharded over its
    batch only (replicated over ``model``), the query heads split evenly
    over ``model``, and a cache (if any) shards its batch and heads, or
    its sequence alone with ``x`` replicated; else None."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if not isinstance(x, DTensor):
        return None
    names = x.device_mesh.mesh_dim_names
    if "model" not in names:
        return None
    md = names.index("model")
    if any(p not in (Shard(0), Replicate()) for p in x.placements) or \
            x.placements[md] != Replicate():
        return None
    if cfg.n_heads % x.device_mesh.size(md):
        return None
    if kv_cache is not None and not isinstance(kv_cache[0], DTensor):
        return None
    if kv_cache is not None and not (
            all(p in (Shard(0), Shard(2), Replicate())
                for p in kv_cache[0].placements)
            or (all(p in (Shard(1), Replicate())
                    for p in kv_cache[0].placements)
                and x.placements == (Replicate(),) * x.device_mesh.ndim)):
        return None
    return md


def _shard_range(t, dim: int) -> Tuple[int, int]:
    """(offset, length) of this rank's shard of DTensor ``t`` along
    ``dim`` (torch.chunk's split, over the mesh dims in order)."""
    mesh, lo, n = t.device_mesh, 0, t.shape[dim]
    coord = mesh.get_coordinate()
    for i, p in enumerate(t.placements):
        if p.is_shard(dim):
            full = -(-n // mesh.size(i))
            lo, n = lo + coord[i] * full, max(0, min(full,
                                                     n - coord[i] * full))
    return lo, n


def _attention_seq_sharded(cfg: TransformerConfig, window: int, lp: Params,
                           h, positions, kv_cache, cache_pos: int):
    """Attention over a cache whose sequence is sharded (``kv_seq``: a
    batch-1 long-context cell), per rank, as a split softmax: each rank
    projects every head (the weights gathered), writes the new keys it
    holds, and attends over its slice of the cache; the slices' maxima,
    sums and weighted values are all-reduced over the sequence's mesh
    dims. Returns this rank's partial (over ``model``) of the output
    projection: its rows of ``wo``. No gradient flows (a decode path)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = h.device_mesh
    names = mesh.mesh_dim_names
    full = {k: replicate_over(v, names).to_local()
            for k, v in lp.items() if k != "wo"}
    acfg = cfg.attn
    x = h.to_local()
    B, S, _ = x.shape
    K, g, hd = cfg.n_kv, cfg.n_heads // cfg.n_kv, cfg.hd
    q, k, v = L.project_qkv(acfg, full, x, positions)
    ck, cv = (c.to_local() for c in kv_cache)
    lo, rows = _shard_range(kv_cache[0], 1)
    a, b = max(cache_pos, lo), min(cache_pos + S, lo + rows)
    if a < b:  # the new positions this rank holds
        ck[:, a - lo:b - lo] = k[:, a - cache_pos:b - cache_pos].to(ck.dtype)
        cv[:, a - lo:b - lo] = v[:, a - cache_pos:b - cache_pos].to(cv.dtype)
    q_pos = positions if positions.ndim > 1 else positions[None, :]
    kv_pos = torch.arange(lo, lo + rows, device=x.device)[None, None, :]
    causal = (kv_pos <= q_pos[:, :, None]) \
        & (kv_pos > q_pos[:, :, None] - window) & (kv_pos < cache_pos + S)
    logits = torch.einsum("bskgh,btkh->bkgst", q.reshape(B, S, K, g, hd), ck)
    logits = L.softcap(logits, acfg.attn_softcap).float()
    logits = torch.where(causal[:, None, None], logits, L._MASKED)
    m = logits.amax(-1, keepdim=True)  # (B, K, g, S, 1)
    e = torch.exp(logits - m)
    tdims = [i for i, p in enumerate(kv_cache[0].placements)
             if p == Shard(1)]

    def all_reduce(t, op):
        pl = [Partial(op) if i in tdims else Replicate()
              for i in range(mesh.ndim)]
        return DTensor.from_local(t, mesh, pl, run_check=False).full_tensor()

    m_all = all_reduce(m, "max")
    w = torch.exp(m - m_all)
    den = all_reduce(e.sum(-1, keepdim=True) * w, "sum")
    num = all_reduce(torch.einsum("bkgst,btkh->bkgsh", e, cv.float()) * w,
                     "sum")
    out = (num / den).to(x.dtype).permute(0, 3, 1, 2, 4).reshape(
        B, S, cfg.n_heads * hd)
    r0, nr = _shard_range(lp["wo"], 0)
    return out[..., r0:r0 + nr] @ lp["wo"].to_local()


def _local(t):
    """A DTensor's local shard for per-rank compute. Its gradient is
    partial over every mesh dim it is replicated on (each rank's compute,
    on its heads or its batch rows, adds its part); plain tensors pass."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if not isinstance(t, DTensor):
        return t
    pl = [Partial() if p == Replicate() else p for p in t.placements]
    return t.to_local(grad_placements=pl)


def _embed(p: _Parts, tokens, policy: ShardingPolicy):
    """``L.embed_tokens`` under a mesh, per rank: each rank looks up the
    tokens of its batch rows that fall in its vocab shard (zeros for the
    rest), a partial sum over the vocab's mesh dims, reduced to the
    activation layout (the masked lookup GSPMD makes of a vocab-sharded
    gather). Plain tensors take ``L.embed_tokens``."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    emb = p.head["embedding"]
    if policy.mesh is None or not isinstance(emb, DTensor):
        return L.embed_tokens(p.head, tokens, scale=p.cfg.scale_embeddings)
    mesh = emb.device_mesh
    tokens = policy.constrain(tokens, ("batch", None))
    if any(q not in (Shard(0), Replicate()) for q in emb.placements) or \
            any(q not in (Shard(0), Replicate()) for q in tokens.placements):
        return L.embed_tokens(p.head, tokens, scale=p.cfg.scale_embeddings)
    lo, rows = _shard_range(emb, 0)  # this rank's vocab rows
    idx = tokens.to_local() - lo
    hit = (idx >= 0) & (idx < rows)
    out = F.embedding(torch.where(hit, idx, 0), _local(emb)) \
        * hit[..., None].to(emb.dtype)
    if p.cfg.scale_embeddings:
        out = out * (emb.shape[-1] ** 0.5)
    pl = [Partial() if e == Shard(0) else t
          for e, t in zip(emb.placements, tokens.placements)]
    shape = tuple(tokens.shape) + (emb.shape[-1],)
    x = DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                           stride=torch.empty(shape, device="meta").stride())
    return policy.constrain(x, ("batch", "seq", None))


def _local_rows(t: torch.Tensor, x) -> torch.Tensor:
    """This rank's rows of a plain (B, ...) tensor made for the whole
    batch of the DTensor ``x`` (a broadcast (1, ...) one unchanged)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    if t.shape[0] != x.shape[0] or Shard(0) not in x.placements:
        return t
    mesh = x.device_mesh
    pl = [Shard(0) if p == Shard(0) else Replicate() for p in x.placements]
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False).redistribute(mesh, pl
                                                            ).to_local()


def _block_tp(cfg: TransformerConfig, window: int, lp: Params, x,
              positions, kv_cache, cache_pos, policy: ShardingPolicy):
    """``block``'s sublayers as Megatron-style tensor parallelism over
    ``model``, the way the reference's GSPMD partitions them: returns the
    attention output and the feed-forward callable for ``_residual``.
    Each rank runs attention on its query heads (and the kv heads they
    read) and the MLP on its slice of d_ff (the MoE on its experts) with
    the plain code on its local shards; each sublayer's output is a
    partial sum over ``model``, reduced by the constraint to the
    activation layout. Norms and residuals stay DTensor ops. A rank whose
    kv heads are replicated reads (and writes to its cache) only those
    its query heads map to. The MoE's capacity is each batch shard's (its
    routing sees the shard's tokens)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    md = _tp_layout(cfg, x, kv_cache)
    mesh = x.device_mesh
    m_sz, m_idx = mesh.size(md), mesh.get_local_rank(md)
    act = ("batch", "seq", None)

    def reduced(y_l):
        pl = [Partial() if i == md else p for i, p in enumerate(x.placements)]
        y = DTensor.from_local(y_l, mesh, pl, run_check=False,
                               shape=x.shape, stride=x.stride())
        return policy.constrain(y, act)

    def ffn(hin):
        if cfg.moe is None:
            mp = tree_lib.tree_map(_local, lp["mlp"])
            return reduced(L.gated_mlp(cfg.mlp, mp, _local(hin)))
        # expert parallelism: the experts are sharded over ``ep`` (model,
        # and pod where the rules say so); a rank's tokens are gathered
        # over the other expert dims, so that each expert sees them all
        wg = lp["moe"]["w_gate"]
        ep = [i for i, q in enumerate(wg.placements) if q == Shard(0)]
        e_idx, e_sz = 0, 1
        for i in ep:
            e_idx, e_sz = e_idx * mesh.size(i) + mesh.get_local_rank(i), \
                e_sz * mesh.size(i)
        if cfg.moe.n_experts % e_sz or (cfg.moe.n_shared and ep != [md]):
            raise ValueError("expert parallelism needs the experts split "
                             "evenly over their mesh dims (and, with "
                             "shared experts, over model only)")
        pl = [Replicate() if i in ep else q
              for i, q in enumerate(hin.placements)]
        hin = hin.redistribute(mesh, pl)
        mp = tree_lib.tree_map(_local, lp["moe"])
        e_loc = cfg.moe.n_experts // e_sz
        y = L.moe_block(cfg.moe, mp, _local(hin), experts=(
            e_idx * e_loc, (e_idx + 1) * e_loc))
        out_pl = [Partial() if i in ep or i == md else q
                  for i, q in enumerate(pl)]
        y = DTensor.from_local(y, mesh, out_pl, run_check=False,
                               shape=hin.shape, stride=hin.stride())
        return policy.constrain(y, act)

    h = L.rms_norm(x, lp["norm_attn"]["scale"])
    if kv_cache is not None and any(p == Shard(1)
                                    for p in kv_cache[0].placements):
        return reduced(_attention_seq_sharded(
            cfg, window, lp["attn"], h, positions, kv_cache, cache_pos)), ffn
    # attention on this rank's heads
    at = {k: _local(v) for k, v in lp["attn"].items()}
    h_loc = at["wq"].shape[1]
    g = cfg.n_heads // cfg.n_kv
    kv = slice(None)
    if at["wk"].shape[1] == cfg.n_kv and m_sz > 1:  # kv heads replicated
        lo = m_idx * h_loc // g
        kv = slice(lo, ((m_idx + 1) * h_loc - 1) // g + 1)
        at["wk"], at["wv"] = at["wk"][:, kv], at["wv"][:, kv]
    acfg = dataclasses.replace(cfg.attn, n_heads=h_loc,
                               n_kv=at["wk"].shape[1])
    pos = _local_rows(positions, x)
    cache = None
    if kv_cache is not None:
        cache = tuple(c.to_local() for c in kv_cache)
        if cache[0].shape[2] == cfg.n_kv:
            cache = tuple(c[:, :, kv] for c in cache)
    T = cache[0].shape[1] if cache is not None else x.shape[1]
    a_l, _ = L.attention(acfg, at, _local(h), pos,
                         mask=_window_mask(pos, T, window),
                         kv_cache=cache, cache_pos=cache_pos)
    return reduced(a_l), ffn


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
    for path, shape in tree_lib.leaves(param_shapes(cfg),
                                       tree_lib.is_shape):
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
    for path, shape in tree_lib.leaves(param_shapes(cfg),
                                       tree_lib.is_shape):
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
                              tree_lib.leaves(param_shapes(model.cfg),
                                              tree_lib.is_shape))


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


def _fsdp(tree: Params, policy: ShardingPolicy) -> Params:
    """FSDP (ZeRO-3) under a mesh: ``tree``'s weights gathered over the
    ``fsdp`` axes for their use (tensor-parallel shards kept); re-gathered
    in a layer's recompute. ``tree`` itself without a mesh."""
    if policy.mesh is None:
        return tree
    return tree_lib.tree_map(
        lambda t: replicate_over(t, policy.rules.get("fsdp")), tree)


def _parts_for(model: Model, policy: ShardingPolicy) -> _Parts:
    p = _parts(model)
    if policy.mesh is None:
        return p
    return dataclasses.replace(p, head=_fsdp(p.head, policy))


def _layer(cfg, window, lp, policy, x, positions):
    return block(cfg, window, _fsdp(lp, policy), x, positions,
                 policy=policy)[0]


def forward_hidden(model: Model, tokens: torch.Tensor,
                   policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """Forward pass up to (but excluding) the LM head: (B, S, d)."""
    with scope(policy):
        return _hidden(_parts_for(model, policy), tokens, policy)


def _hidden(p: _Parts, tokens: torch.Tensor,
            policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    cfg = p.cfg
    B, S = tokens.shape
    x = policy.constrain(_embed(p, tokens, policy), ("batch", "seq", None))
    positions = torch.arange(S, device=tokens.device).expand(B, S)
    for window, lp in p.layers:
        # the layer's parameters are closed over, so a recompute in the
        # backward reads the same tensors
        x = _remat(cfg, functools.partial(_layer, cfg, window, lp, policy),
                   x, positions)
    return L.rms_norm(x, p.final_scale)


def forward(model: Model, tokens: torch.Tensor,
            policy: ShardingPolicy = NO_SHARDING) -> torch.Tensor:
    """tokens: (B, S) int -> logits (B, S, vocab)."""
    with scope(policy):
        p = _parts_for(model, policy)
        logits = L.lm_logits(p.head, _hidden(p, tokens, policy),
                             cap=p.cfg.final_softcap,
                             tied=p.cfg.tie_embeddings)
        # NB: seq stays unsharded here — "seq" and "vocab" both map to model
        return policy.constrain(logits, ("batch", None, "vocab"))


def _gold(logits: torch.Tensor, targets: torch.Tensor,
          policy: ShardingPolicy) -> torch.Tensor:
    """The target's logit. Under a mesh a select-and-sum over the (vocab-
    sharded) last dim, exactly the gathered value for finite logits, where
    DTensor's gather of a sharded dim cannot reduce its partial result."""
    if policy.mesh is None:
        return torch.gather(logits, -1, targets[..., None])[..., 0]
    vocab = torch.arange(logits.shape[-1], device=targets.device)
    return torch.where(vocab == targets[..., None], logits, 0.0).sum(-1)


def _chunk_loss(hx, tx, w, cap, policy=NO_SHARDING):
    # pins the chunk's gradient to the activation layout under a mesh
    hx = policy.constrain(hx, ("batch", "seq", None))
    logits = L.softcap(torch.einsum("bsd,dv->bsv", hx, w), cap).float()
    logits = policy.constrain(logits, ("batch", None, "vocab"))
    logz = torch.logsumexp(logits, dim=-1)
    return torch.sum(logz - _gold(logits, tx, policy))


def loss_fn(model: Model, tokens: torch.Tensor, targets: torch.Tensor,
            policy: ShardingPolicy = NO_SHARDING, *,
            chunks: int = 1) -> torch.Tensor:
    """Next-token cross entropy, a mean over the (B, S) targets.

    ``chunks > 1``: chunked CE — the (B, S, vocab) logits tensor is never
    materialized whole; each sequence chunk's logits are computed,
    consumed, and (in the backward, by ``torch.utils.checkpoint``)
    recomputed. The chunk sums add in chunk order, as the reference's
    scan does.
    """
    with scope(policy):
        return _loss(model, tokens, targets.long(), policy, chunks)


def _loss(model: Model, tokens, targets, policy, chunks: int):
    if chunks <= 1:
        logits = forward(model, tokens, policy).float()
        logz = torch.logsumexp(logits, dim=-1)
        return torch.mean(logz - _gold(logits, targets, policy))

    p = _parts_for(model, policy)
    cfg = p.cfg
    h = _hidden(p, tokens, policy)
    B, S, D = h.shape
    assert S % chunks == 0, (S, chunks)
    c = S // chunks
    if policy.mesh is None:
        hc = h.reshape(B, chunks, c, D).transpose(0, 1)
        tc = targets.reshape(B, chunks, c).transpose(0, 1)
    else:  # sequence slices: DTensor cannot propagate the reshape's grad
        hc = [h.narrow(1, i * c, c) for i in range(chunks)]
        tc = [targets.narrow(1, i * c, c) for i in range(chunks)]
    w = p.head["embedding"].T if cfg.tie_embeddings else p.head["lm_head"]
    total = torch.zeros((), dtype=torch.float32, device=h.device)
    for i in range(chunks):
        if torch.is_grad_enabled():
            part = ckpt.checkpoint(_chunk_loss, hc[i], tc[i], w,
                                   cfg.final_softcap, policy,
                                   use_reentrant=False)
        else:
            part = _chunk_loss(hc[i], tc[i], w, cfg.final_softcap, policy)
        total = total + part
    return total / (B * S)


# ---------------------------------------------------------------------------
# Serving: KV cache, prefill, decode.
# ---------------------------------------------------------------------------


def _cache_logical(cfg: TransformerConfig, batch: int,
                   policy: ShardingPolicy):
    """KV cache sharding: batch over DP when batch > 1; KV heads over
    ``model`` when divisible, else the sequence dim; batch-1 long-context
    cells spread the sequence over every axis (``kv_seq``)."""
    if batch == 1:
        return (None, None, "kv_seq", None, None)
    if cfg.n_kv % max(policy.model_size, 1) == 0 and policy.model_size > 1:
        return (None, "batch", None, "model", None)
    return (None, "batch", "seq", None, None)


def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               dtype: torch.dtype = torch.float32, device="cuda",
               policy: ShardingPolicy = NO_SHARDING):
    """(k, v), each (n_layers, batch, max_len, n_kv, hd) zeros, placed by
    ``policy`` (its cache rule) when it has a mesh."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    dev = resolve_device(device)
    logical = _cache_logical(cfg, batch, policy)
    return tuple(policy.constrain(torch.zeros(shape, dtype=dtype,
                                              device=dev), logical)
                 for _ in range(2))


def cache_abstract(cfg: TransformerConfig, batch: int, max_len: int,
                   policy: ShardingPolicy = NO_SHARDING,
                   dtype: torch.dtype = torch.float32, device="cpu"):
    """``init_cache``'s (k, v), uninitialized (``sharding.abstract``)."""
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv, cfg.hd)
    sh = policy.named(_cache_logical(cfg, batch, policy))
    return tuple(abstract(shape, dtype, sh, device) for _ in range(2))


def _layers_cached(p: _Parts, x, positions, cache, cache_pos: int,
                   policy: ShardingPolicy):
    ck, cv = cache
    for l, (window, lp) in enumerate(p.layers):
        x, _ = block(p.cfg, window, _fsdp(lp, policy), x, positions,
                     kv_cache=(ck[l], cv[l]), cache_pos=cache_pos,
                     policy=policy)
    return x, (ck, cv)


def prefill(model: Model, tokens: torch.Tensor, cache,
            policy: ShardingPolicy = NO_SHARDING):
    """Fill the cache with a prompt; returns (logits_last, cache)."""
    B, S = tokens.shape
    with scope(policy):
        p = _parts_for(model, policy)
        cfg = p.cfg
        x = _embed(p, tokens, policy)
        positions = torch.arange(S, device=tokens.device).expand(B, S)
        x, cache = _layers_cached(p, x, positions, cache, 0, policy)
        x = L.rms_norm(x, p.final_scale)
        logits = L.lm_logits(p.head, x[:, -1:], cap=cfg.final_softcap,
                             tied=cfg.tie_embeddings)
    return logits, cache


def decode_step(model: Model, token: torch.Tensor, pos: int, cache,
                policy: ShardingPolicy = NO_SHARDING):
    """One decode step. token: (B, 1) int; pos: the cache fill, the same
    for every row. Returns (logits (B, 1, V), cache)."""
    B = token.shape[0]
    pos = int(pos)
    with scope(policy):
        p = _parts_for(model, policy)
        cfg = p.cfg
        x = _embed(p, token, policy)
        positions = torch.full((B, 1), pos, dtype=torch.long,
                               device=token.device)
        x, cache = _layers_cached(p, x, positions, cache, pos, policy)
        x = L.rms_norm(x, p.final_scale)
        logits = L.lm_logits(p.head, x, cap=cfg.final_softcap,
                             tied=cfg.tie_embeddings)
    return logits, cache
