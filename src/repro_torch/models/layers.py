"""Transformer building blocks: RMSNorm, RoPE, GQA attention (softcap +
sliding window), gated MLP, and capacity-based top-k MoE.

A port of ``repro/models/layers.py``. The functions take a layer's
parameters as a dict of tensors named as in the reference's tree, and
compute what the reference's do in the same order of operations; the
thin ``nn.Module``s (``RMSNorm``, ``Attention``, ``GatedMlp``,
``MoeBlock``) hold one layer's parameters under those names and call
them. The products are ``torch.einsum`` / ``@`` (the reference computes
them outside any Pallas kernel too); attention mirrors the reference's
einsum form rather than ``scaled_dot_product_attention``, which has no
softcap.

One difference of interface: ``attention`` with a KV cache writes the new
keys and values into the cache tensors in place and returns them (the
reference returns an updated copy), so a cache row can be a view of a
larger cache.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

Params = Dict[str, Any]
_MASKED = -1e30  # the logit of a masked key, set after the softcap


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6,
             zero_centered: bool = True) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(torch.square(xf), dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    w = (1.0 + scale) if zero_centered else scale
    return (y * w).to(x.dtype)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0
         ) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq). Rotates the
    split halves of head_dim (not interleaved pairs)."""
    d = x.shape[-1]
    half = d // 2
    # the frequencies are raised on the host: the card's pow differs from
    # the CPU's (and the reference's) in the last place, which a position
    # in the hundreds turns into ~1e-5 rad
    freq = (theta ** (-torch.arange(0, half, dtype=torch.float32) / half)
            ).to(x.device)
    angles = positions[..., None].float() * freq  # (..., seq, half)
    cos = torch.cos(angles)[..., None, :]  # broadcast over heads
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def softcap(x: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    if cap is None:
        return x
    return cap * torch.tanh(x / cap)


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv: int
    head_dim: int
    rope_theta: float = 10000.0
    attn_softcap: Optional[float] = None  # gemma2: 50.0
    window: Optional[int] = None  # sliding-window size for local layers
    query_scale: Optional[float] = None  # default 1/sqrt(head_dim)


def _write(cache: torch.Tensor, new: torch.Tensor, pos: int) -> None:
    """``cache[:, pos:pos + S] = new`` in place; raises where the
    reference's ``dynamic_update_slice`` would clamp the start instead."""
    S, T = new.shape[1], cache.shape[1]
    if not 0 <= pos <= T - S:
        raise ValueError(f"cache write of {S} positions at {pos} does not "
                         f"fit a cache of {T}")
    cache[:, pos:pos + S] = new.to(cache.dtype)


def project_qkv(cfg: AttnConfig, p: Params, x: torch.Tensor,
                positions: torch.Tensor):
    """Attention's q (rotated, scaled), k (rotated) and v: (B, S, heads,
    hd)."""
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"]).reshape(B, S, H, hd)
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"]).reshape(B, S, K, hd)
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"]).reshape(B, S, K, hd)
    q = rope(q, positions, cfg.rope_theta)
    k = rope(k, positions, cfg.rope_theta)
    scale = cfg.query_scale if cfg.query_scale is not None else hd ** -0.5
    return q * scale, k, v


def attention(cfg: AttnConfig, p: Params, x: torch.Tensor,
              positions: torch.Tensor, *,
              mask: Optional[torch.Tensor] = None,
              kv_cache: Optional[Tuple[torch.Tensor, torch.Tensor]] = None,
              cache_pos: Optional[int] = None
              ) -> Tuple[torch.Tensor, Optional[Tuple]]:
    """GQA attention.

    x: (B, S, d). With ``kv_cache=(k, v)`` of shape (B, S_max, n_kv, hd),
    writes the new keys/values at ``cache_pos`` (in place) and attends over
    the whole cache, masking positions at or past ``cache_pos + S``
    (decode / chunked prefill). Returns (out, cache).
    """
    B, S, _ = x.shape
    H, K, hd = cfg.n_heads, cfg.n_kv, cfg.head_dim
    q, k, v = project_qkv(cfg, p, x, positions)

    if kv_cache is not None:
        ck, cv = kv_cache
        cache_pos = int(cache_pos)
        _write(ck, k, cache_pos)
        _write(cv, v, cache_pos)
        k_all, v_all = ck, cv
        kv_positions = torch.arange(ck.shape[1], device=x.device)
        new_cache = (ck, cv)
    else:
        k_all, v_all = k, v
        kv_positions = positions[0] if positions.ndim > 1 else positions
        new_cache = None

    g = H // K  # queries per kv group: query head h reads kv head h // g
    qg = q.reshape(B, S, K, g, hd)
    logits = torch.einsum("bskgh,btkh->bkgst", qg, k_all)
    logits = softcap(logits, cfg.attn_softcap)

    q_pos = positions if positions.ndim > 1 else positions[None, :]
    causal = kv_positions[None, None, :] <= q_pos[:, :, None]  # (B, S, T)
    if cfg.window is not None:
        causal &= kv_positions[None, None, :] > q_pos[:, :, None] - cfg.window
    if kv_cache is not None:
        causal &= kv_positions[None, None, :] < (cache_pos + S)
    if mask is not None:
        causal &= mask
    logits = torch.where(causal[:, None, None, :, :], logits, _MASKED)

    probs = torch.softmax(logits.float(), dim=-1).to(x.dtype)
    out = torch.einsum("bkgst,btkh->bskgh", probs, v_all).reshape(B, S, H * hd)
    out = torch.einsum("bse,ed->bsd", out, p["wo"])
    return out, new_cache


@dataclasses.dataclass(frozen=True)
class MlpConfig:
    d_ff: int
    act: str = "silu"  # silu (llama/command-r) | gelu (gemma2/granite)
    style: str = "gated"  # gated (SwiGLU/GeGLU) | plain (GPT-BigCode)


def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _act(name: str):
    """silu, gelu (the tanh approximation, as ``jax.nn.gelu``'s default)
    or relu."""
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu}[name]


def gated_mlp(cfg: MlpConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    if cfg.style == "plain":
        return _act(cfg.act)(x @ p["w_up"]) @ p["w_down"]
    h = _act(cfg.act)(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]


@dataclasses.dataclass(frozen=True)
class MoeConfig:
    n_experts: int
    top_k: int
    d_ff: int  # per-expert ffn width
    act: str = "silu"
    capacity_factor: float = 1.25
    router_softcap: Optional[float] = None
    n_shared: int = 0  # shared (always-on) experts, moonshot-style
    d_ff_shared: int = 0


def moe_block(cfg: MoeConfig, p: Params, x: torch.Tensor,
              policy=None, experts: Optional[Tuple[int, int]] = None
              ) -> torch.Tensor:
    """Capacity-based top-k MoE with sort-based dispatch: each (token,
    choice) takes its rank within its expert from one stable sort; past
    ``cap`` it goes to the drop slot ``E·cap``. Tokens are scatter-added
    into an (E, cap, d) buffer, the experts run as one batched einsum, and
    the gated outputs are scatter-added back to their tokens
    (``index_add_``: in index order on the CPU, by atomics on the card).
    With a ``policy``, the expert-major buffers are constrained to
    (expert, batch, ·): the token→expert resharding is the MoE's
    all-to-all. ``experts=(lo, hi)``: ``p``'s expert weights are experts
    lo..hi-1 only (one rank's under expert parallelism); the routing is
    over all ``n_experts``, choices of other experts are dropped, and the
    output is this rank's part of the sum (the shared experts' included:
    their weights are this rank's shards too).
    """
    B, S, D = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.top_k
    dev = x.device
    xt = x.reshape(T, D)
    logits = softcap(xt @ p["router"], cfg.router_softcap)  # (T, E)
    gates = torch.softmax(logits.float(), dim=-1)
    top_g, top_e = torch.topk(gates, K)  # (T, K)
    top_g = (top_g / torch.clamp(top_g.sum(-1, keepdim=True), min=1e-9)
             ).to(x.dtype)

    cap = max(int(math.ceil(T * K / E * cfg.capacity_factor)), 4)
    flat_e = top_e.reshape(-1)  # (T*K,)
    flat_g = top_g.reshape(-1)
    flat_tok = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    # (E,): a scatter-add, not ``bincount``, whose output size depends on
    # the data (a fake tensor has none)
    counts = torch.zeros(E, dtype=flat_e.dtype, device=dev).scatter_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(flat_e)
    rank[order] = torch.arange(T * K, device=dev) - starts[sorted_e]
    keep = rank < cap
    if experts is not None:  # this rank's experts only
        lo, hi = experts
        keep = keep & (flat_e >= lo) & (flat_e < hi)
        flat_e, E = flat_e - lo, hi - lo
    slot = torch.where(keep, flat_e * cap + rank, E * cap)  # drop -> scratch

    buf = torch.zeros(E * cap + 1, D, dtype=x.dtype, device=dev)
    buf.index_add_(0, slot, xt[flat_tok])
    buf = buf[:E * cap].reshape(E, cap, D)
    if policy is not None:
        buf = policy.constrain(buf, ("expert", "batch", None))
    h = _act(cfg.act)(torch.einsum("ecd,edf->ecf", buf, p["w_gate"]))
    h = h * torch.einsum("ecd,edf->ecf", buf, p["w_up"])
    if policy is not None:
        h = policy.constrain(h, ("expert", "batch", None))
    yb = torch.einsum("ecf,efd->ecd", h, p["w_down"]).reshape(E * cap, D)
    yb = torch.cat([yb, torch.zeros(1, D, dtype=yb.dtype, device=dev)])
    gate = torch.where(keep, flat_g, torch.zeros((), dtype=flat_g.dtype,
                                                 device=dev))
    y = torch.zeros(T, D, dtype=x.dtype, device=dev)
    y.index_add_(0, flat_tok, yb[slot] * gate[:, None])

    if cfg.n_shared:
        sh = MlpConfig(cfg.d_ff_shared or cfg.d_ff, cfg.act)
        y = y + gated_mlp(sh, p["shared"], xt)
    return y.reshape(B, S, D)


def embed_tokens(p: Params, tokens: torch.Tensor, *, scale: bool = False
                 ) -> torch.Tensor:
    # F.embedding, not indexing: its backward sums the rows of repeated
    # tokens in a fixed order (indexing's ``index_put_`` accumulates in
    # parallel on the CPU, in an order that varies from run to run)
    emb = F.embedding(tokens, p["embedding"])
    if scale:
        emb = emb * (p["embedding"].shape[-1] ** 0.5)
    return emb


def lm_logits(p: Params, x: torch.Tensor, *, cap: Optional[float] = None,
              tied: bool = True) -> torch.Tensor:
    w = p["embedding"].T if tied else p["lm_head"]
    return softcap(torch.einsum("bsd,dv->bsv", x, w), cap)


# ---------------------------------------------------------------------------
# Modules holding one layer's parameters.
# ---------------------------------------------------------------------------


class LayerParams(nn.Module):
    """Parameters named as in the reference's tree: one frozen tensor per
    leaf of ``shapes`` (uninitialized), a child module per sub-dict.
    Serving needs no gradients; the training slice turns them on."""

    def __init__(self, shapes: Dict[str, Any], *, dtype: torch.dtype,
                 device: torch.device):
        super().__init__()
        for name, shape in shapes.items():
            if isinstance(shape, dict):
                self.add_module(name, LayerParams(shape, dtype=dtype,
                                                  device=device))
            else:
                self.register_parameter(name, nn.Parameter(
                    torch.empty(shape, dtype=dtype, device=device),
                    requires_grad=False))

    def tree(self) -> Params:
        """The parameters as the reference's nested dict (the tensors
        themselves, not copies)."""
        out: Params = dict(self._parameters)
        out.update((k, m.tree()) for k, m in self._modules.items())
        return out


class RMSNorm(LayerParams):
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return rms_norm(x, self.scale)


class Attention(LayerParams):
    def __init__(self, cfg: AttnConfig, shapes, *, dtype, device):
        super().__init__(shapes, dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x, positions, **kw):
        return attention(self.cfg, self.tree(), x, positions, **kw)


class GatedMlp(LayerParams):
    def __init__(self, cfg: MlpConfig, shapes, *, dtype, device):
        super().__init__(shapes, dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x):
        return gated_mlp(self.cfg, self.tree(), x)


class MoeBlock(LayerParams):
    def __init__(self, cfg: MoeConfig, shapes, *, dtype, device):
        super().__init__(shapes, dtype=dtype, device=device)
        self.cfg = cfg

    def forward(self, x, policy=None):
        return moe_block(self.cfg, self.tree(), x, policy)
