"""xDeepFM [Lian et al., arXiv:1803.05170]: linear + CIN + DNN over sparse
categorical fields.

A port of ``repro/models/recsys.py``. The EmbeddingBag is one flat table
with per-field offsets: an ``F.embedding`` lookup (whose backward adds
the rows' gradients in a fixed order on the CPU) and an in-bag sum or
mean. ``linear`` (a (V,) vector) is looked up as a (V, 1) view.

CIN (Compressed Interaction Network): x^{k+1}_h = Σ_{i,j} W^k_{h,i,j}
(x^k_i ∘ x^0_j), kept as the reference's two einsums per layer (the
outer product (B, H_k, m, D), then its contraction with W^k), sum-pooled
over the embedding dim into the final logit.

``init_shapes`` keeps the (shape, logical axes) pairs as data;
``abstract_params`` gives the tree uninitialized (fake or meta), placed
by a policy's ``named`` of each leaf's logical axes. As in the
reference, the table's and ``linear``'s axes are one tuple for their row
dim, ``("model", "fsdp")``, which no rule names: they stay replicated.
``forward``, ``bce_loss`` and ``retrieval_score`` take ``policy`` and
constrain the ids and the candidates to the batch axes.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
from repro_torch.sharding.rules import abstract
# the parameter tree's round trip to the reference
from repro_torch.train.checkpoint import (params_from_reference,  # noqa: F401
                                         params_to_numpy)

Params = Dict[str, Any]


@dataclasses.dataclass(frozen=True)
class XDeepFMConfig:
    name: str
    n_fields: int = 39
    vocab_per_field: int = 1_000_000  # uniform for the synthetic pipeline
    embed_dim: int = 10
    cin_layers: Tuple[int, ...] = (200, 200, 200)
    mlp_layers: Tuple[int, ...] = (400, 400)
    multi_hot: int = 1  # ids per field (bag size)

    @property
    def total_vocab(self) -> int:
        # padded to a mesh-divisible row count (512 = model x fsdp ways)
        raw = self.n_fields * self.vocab_per_field
        return -(-raw // 512) * 512

    def n_params(self) -> int:
        m = self.n_fields
        n = self.total_vocab * self.embed_dim + self.total_vocab  # emb + linear
        prev = m
        for h in self.cin_layers:
            n += h * prev * m  # W^k: (H_k, H_{k-1}, m)
            prev = h
        d = m * self.embed_dim
        for h in self.mlp_layers:
            n += d * h + h
            d = h
        n += d + sum(self.cin_layers) + 1
        return n


def _dense(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.randn(shape, generator=generator,
                       device=generator.device) / np.sqrt(max(shape[0], 1))


def init_params(cfg: XDeepFMConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """The reference's distribution from ``generator``'s stream: the
    table normal × 0.01, ``linear`` and ``bias`` zero, the CIN and MLP
    weights normal / sqrt(shape[0]), the MLP biases zero."""
    dev = resolve_device(device)
    g = generator
    p: Params = {
        "table": torch.randn((cfg.total_vocab, cfg.embed_dim), generator=g,
                             device=g.device) * 0.01,
        "linear": torch.zeros((cfg.total_vocab,), device=g.device),
        "bias": torch.zeros((), device=g.device),
    }
    prev = cfg.n_fields
    cin = []
    for h in cfg.cin_layers:
        cin.append(_dense(g, (h, prev, cfg.n_fields)))
        prev = h
    p["cin"] = cin
    p["cin_out"] = _dense(g, (sum(cfg.cin_layers),))
    mlp = []
    d = cfg.n_fields * cfg.embed_dim
    for h in cfg.mlp_layers:
        mlp.append({"w": _dense(g, (d, h)),
                    "b": torch.zeros(h, device=g.device)})
        d = h
    p["mlp"] = mlp
    p["mlp_out"] = _dense(g, (d,))
    return tree_lib.tree_map(lambda t: t.to(dev), p)


def init_shapes(cfg: XDeepFMConfig):
    """(shape, logical_axes) pairs; table rows shard over (model, fsdp)."""
    prev = cfg.n_fields
    cin = []
    for h in cfg.cin_layers:
        cin.append(((h, prev, cfg.n_fields), (None, None, None)))
        prev = h
    d = cfg.n_fields * cfg.embed_dim
    mlp = []
    for h in cfg.mlp_layers:
        mlp.append({"w": ((d, h), (None, None)), "b": ((h,), (None,))})
        d = h
    return {
        "table": ((cfg.total_vocab, cfg.embed_dim), (("model", "fsdp"), None)),
        "linear": ((cfg.total_vocab,), (("model", "fsdp"),)),
        "bias": ((), ()),
        "cin": cin,
        "cin_out": ((sum(cfg.cin_layers),), (None,)),
        "mlp": mlp,
        "mlp_out": ((d,), (None,)),
    }


def abstract_params(cfg: XDeepFMConfig, policy=None, device="cpu"):
    """The parameter tree uninitialized (``sharding.abstract``), each leaf
    placed by ``policy.named`` of its logical axes under a mesh."""
    def walk(t):
        if isinstance(t, dict):
            return {k: walk(v) for k, v in t.items()}
        if isinstance(t, list):
            return [walk(v) for v in t]
        shape, logical = t
        sh = policy.named(logical) if policy is not None \
            and policy.mesh is not None else None
        return abstract(shape, torch.float32, sh, device)

    return walk(init_shapes(cfg))


def _constrain(policy, x, logical):
    return x if policy is None else policy.constrain(x, logical)


def embedding_bag(table: torch.Tensor, ids: torch.Tensor, weights=None,
                  combine: str = "sum") -> torch.Tensor:
    """ids: (B, F, H) flat-vocab ids (H = bag size). -> (B, F, D).

    The from-scratch EmbeddingBag: gather + in-bag reduction. For H == 1
    this is a plain lookup.
    """
    if combine not in ("sum", "mean"):
        raise ValueError(combine)
    emb = F.embedding(ids.long(), table)  # (B, F, H, D)
    if weights is not None:
        emb = emb * weights[..., None]
    if combine == "sum":
        return torch.sum(emb, dim=2)
    return torch.mean(emb, dim=2)


def forward(cfg: XDeepFMConfig, p: Params, ids: torch.Tensor,
            policy=None) -> torch.Tensor:
    """ids: (B, n_fields, multi_hot) flat ids -> logits (B,)."""
    B = ids.shape[0]
    ids = _constrain(policy, ids.long(), ("batch", None, None))
    x0 = embedding_bag(p["table"], ids)  # (B, m, D)
    lin = torch.sum(F.embedding(ids, p["linear"][:, None])[..., 0],
                    dim=(1, 2))  # (B,)

    # CIN branch
    xk = x0
    pooled = []
    for w in p["cin"]:
        inter = torch.einsum("bhd,bmd->bhmd", xk, x0)  # (B, H_k, m, D)
        xk = torch.einsum("bhmd,nhm->bnd", inter, w)  # (B, H_{k+1}, D)
        del inter
        pooled.append(torch.sum(xk, dim=-1))  # (B, H_{k+1})
    cin_logit = torch.cat(pooled, dim=-1) @ p["cin_out"]

    # DNN branch
    h = x0.reshape(B, -1)
    for lp in p["mlp"]:
        h = F.relu(h @ lp["w"] + lp["b"])
    mlp_logit = h @ p["mlp_out"]

    return lin + cin_logit + mlp_logit + p["bias"]


def bce_loss(cfg: XDeepFMConfig, p: Params, ids: torch.Tensor,
             labels: torch.Tensor, policy=None) -> torch.Tensor:
    logits = forward(cfg, p, ids, policy)
    return torch.mean(torch.clamp(logits, min=0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def retrieval_score(cfg: XDeepFMConfig, p: Params, query_ids: torch.Tensor,
                    cand_ids: torch.Tensor, policy=None) -> torch.Tensor:
    """retrieval_cand cell: one query (1, F, H) against N candidate items.

    Candidates are represented by their item-field ids (N, Fc, H). Scoring
    is a batched dot between the query's pooled user vector and candidate
    embeddings — a single matmul, not a loop.
    """
    q = embedding_bag(p["table"], query_ids)  # (1, F, D)
    qv = q.mean(dim=1)  # (1, D)
    c = embedding_bag(p["table"], cand_ids)  # (N, Fc, D)
    cv = _constrain(policy, c.mean(dim=1), ("batch", None))  # (N, D)
    return cv @ qv[0]  # (N,)
