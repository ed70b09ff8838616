"""GNN architecture family: GCN, GIN, GAT, and an E(3)-equivariant
NequIP-class network.

A port of ``repro/models/gnn.py``. Message passing is a gather
(``index_select``) and a segment sum (``index_add_`` into zeros, saving
only its index for the backward) or
segment max (``scatter_reduce_(..., "amax")`` into ``-inf``) over a
padded edge list. Padding edges point at a dummy node slot ``n`` (arrays
are sized n+1) so they are algebraically inert. Every index must lie in
``[0, n]``: the reference clamps or drops an index out of range, PyTorch
raises on the CPU and asserts on the card, so batches are checked where
they are built (``check_indices``).

Gathers go through ``index_select``, not indexing: on the CPU indexing's
backward adds in a varying order, ``index_select``'s (an ``index_add_``)
in edge order. On the card ``index_add_`` and ``scatter_reduce_`` add by
atomics, so a step repeats only within rounding there.

The models are plain functions on the reference's parameter tree (dicts
and lists of tensors), so a train state is that tree; ``*_init`` draws
the reference's distribution (normal / sqrt(fan_in); the reference's
zero leaves zero) from a ``torch.Generator``'s stream, and
``params_from_reference`` / ``params_to_numpy`` carry a tree from and to
the reference bit for bit.

NequIP (arXiv:2101.03164) is realized with l_max = 2 in the *Cartesian*
tensor basis — features are (scalars, vectors, traceless-symmetric
rank-2) channels and the Clebsch-Gordan products become closed-form
Cartesian contractions (TensorNet-style, arXiv:2306.06482).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch import tree as tree_lib
# the parameter tree's round trip to the reference
from repro_torch.train.checkpoint import (params_from_reference,  # noqa: F401
                                         params_to_numpy)

Params = Dict[str, Any]


def _sharded(*ts) -> bool:
    from torch.distributed.tensor import DTensor

    return any(isinstance(t, DTensor) for t in ts)


def _row_placements(idx):
    """Placements of a tensor whose rows follow ``idx``'s (a DTensor's
    dim-0 sharding, replicated on its other mesh dims)."""
    from torch.distributed.tensor import Replicate, Shard

    return [Shard(0) if p == Shard(0) else Replicate()
            for p in idx.placements]


def _as_dtensor(t, mesh):
    from torch.distributed.tensor import DTensor, Replicate

    if isinstance(t, DTensor):
        return t
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


def _gather_sharded(x, idx):
    """``_gather`` over DTensors, as GSPMD partitions message passing (the
    paper's 1D variant C): ``x`` all-gathered, each rank gathering the
    rows of its own ids; the result is sharded as ``idx``. The gathered
    copy's gradient is partial over the dims ``idx`` is sharded on."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (idx if isinstance(idx, DTensor) else x).device_mesh
    x, idx = _as_dtensor(x, mesh), _as_dtensor(idx, mesh)
    grad_pl = [Partial() if p == Shard(0) else Replicate()
               for p in idx.placements]
    full = x.redistribute(mesh, [Replicate()] * mesh.ndim).to_local(
        grad_placements=grad_pl)
    out = torch.index_select(full, 0, idx.to_local())
    shape = (idx.shape[0],) + tuple(x.shape[1:])
    return DTensor.from_local(out, mesh, _row_placements(idx),
                              run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def _segment_sharded(fn, x, idx, n: int, op: str):
    """A segment reduction over DTensors: ``x`` placed as ``idx``, each
    rank reducing its own rows into a full (n, ·) partial, ``Partial(op)``
    over the mesh dims ``idx`` is sharded on, all-reduced: the paper's 1D
    variant C (a full-size partial and its all-reduce, ~2|H| bytes a
    rank), which GSPMD makes of the reference's segment sums."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = (idx if isinstance(idx, DTensor) else x).device_mesh
    x, idx = _as_dtensor(x, mesh), _as_dtensor(idx, mesh)
    x = x.redistribute(mesh, _row_placements(idx))
    out = fn(x.to_local(), idx.to_local(), n)
    pl = [Partial(op) if p == Shard(0) else Replicate()
          for p in idx.placements]
    shape = (n,) + tuple(x.shape[1:])
    out = DTensor.from_local(out, mesh, pl, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta")
                             .stride())
    return out.redistribute(mesh, [Replicate()] * mesh.ndim)


# NequIP's contractions as matmuls and sums, for DTensors: DTensor's
# einsum flattens dims into a bmm whose shardings it cannot propagate
_EINSUM_SHARDED = {
    "eci,ei->ec": lambda a, b: (a * b[:, None, :]).sum(-1),
    "ecij,ej->eci": lambda a, b: (a * b[:, None, None, :]).sum(-1),
    "ncx,cd->ndx": lambda a, b: (a.transpose(1, 2) @ b).transpose(1, 2),
    "ncxy,cd->ndxy": lambda a, b: (a.permute(0, 2, 3, 1) @ b
                                   ).permute(0, 3, 1, 2),
    "ncxy,ncxy->nc": lambda a, b: (a * b).sum((-2, -1)),
}


def _einsum(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    if _sharded(a, b):
        return _EINSUM_SHARDED[eq](a, b)
    return torch.einsum(eq, a, b)


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    if _sharded(x, idx):
        return _gather_sharded(x, idx)
    return torch.index_select(x, 0, idx)


class _SegSum(torch.autograd.Function):
    """``index_add_`` into zeros, whose backward (a gather of the
    gradient) keeps only the index: autograd's own ``index_add_`` saves
    its source for the backward, an (E, d) message tensor a layer (88 GB
    over GIN's five layers on ogb_products)."""

    @staticmethod
    def forward(ctx, x, idx, n: int):
        ctx.save_for_backward(idx)
        return x.new_zeros((n,) + x.shape[1:]).index_add_(0, idx, x)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        return torch.index_select(grad, 0, idx), None, None


def _seg_sum(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    if _sharded(x, idx):
        return _segment_sharded(_SegSum.apply, x, idx, n, "sum")
    return _SegSum.apply(x, idx, n)


def _seg_max(x: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """Each segment's max, ``-inf`` for an empty one (as the reference's
    ``segment_max``)."""
    if _sharded(x, idx):
        return _segment_sharded(_seg_max, x, idx, n, "max")
    out = x.new_full((n,) + x.shape[1:], -math.inf)
    index = idx.long().reshape((-1,) + (1,) * (x.ndim - 1)).expand_as(x)
    return out.scatter_reduce_(0, index, x, "amax", include_self=False)


def check_indices(batch: Dict[str, Any], n1: int) -> None:
    """Raises unless every edge endpoint of ``batch`` lies in [0, n1) and
    every ``graph_ids`` entry in [0, n_graphs) (numpy arrays or
    tensors)."""
    bounds = {"src": n1, "dst": n1}
    if "graph_ids" in batch and "n_graphs" in batch:
        bounds["graph_ids"] = int(batch["n_graphs"])
    for k, hi in bounds.items():
        idx = torch.as_tensor(batch[k])
        if idx.numel() and (int(idx.min()) < 0 or int(idx.max()) >= hi):
            raise ValueError(f"{k} holds ids outside [0, {hi})")


def _dense(generator: torch.Generator, shape, scale=None) -> torch.Tensor:
    fan_in = shape[0]
    scale = scale if scale is not None else 1.0 / np.sqrt(max(fan_in, 1))
    return torch.randn(shape, generator=generator,
                       device=generator.device) * scale


def _zeros(generator: torch.Generator, shape) -> torch.Tensor:
    return torch.zeros(shape, device=generator.device)


def _placed(tree, device) -> Params:
    dev = resolve_device(device)
    return tree_lib.tree_map(lambda t: t.to(dev), tree)


# ---------------------------------------------------------------------------
# GCN [Kipf & Welling, arXiv:1609.02907]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GCNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 16
    d_in: int = 1433
    n_classes: int = 7
    dropout: float = 0.0  # deterministic eval path


def gcn_init(cfg: GCNConfig, generator: torch.Generator,
             device="cuda") -> Params:
    dims = [cfg.d_in] + [cfg.d_hidden] * (cfg.n_layers - 1) + [cfg.n_classes]
    return _placed({"w": [_dense(generator, (dims[i], dims[i + 1]))
                          for i in range(cfg.n_layers)]}, device)


def gcn_forward(cfg: GCNConfig, p: Params, batch) -> torch.Tensor:
    """batch: x (n+1, d_in), src/dst (E,), deg (n+1,). Sym-normalized."""
    x, src, dst = batch["x"], batch["src"], batch["dst"]
    n1 = x.shape[0]
    dinv = torch.rsqrt(torch.clamp(batch["deg"].to(x.dtype), min=1.0))
    coef = (_gather(dinv, src) * _gather(dinv, dst))[:, None]
    for i, w in enumerate(p["w"]):
        h = x @ w
        h = (_seg_sum(_gather(h, src) * coef, dst, n1)
             + h * (dinv * dinv)[:, None])
        x = F.relu(h) if i + 1 < len(p["w"]) else h
    return x


# ---------------------------------------------------------------------------
# GIN [Xu et al., arXiv:1810.00826]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GINConfig:
    name: str
    n_layers: int = 5
    d_hidden: int = 64
    d_in: int = 7
    n_classes: int = 2
    learn_eps: bool = True  # as the reference: read nowhere, eps is trained


def gin_init(cfg: GINConfig, generator: torch.Generator,
             device="cuda") -> Params:
    mlps = []
    d_prev = cfg.d_in
    for _ in range(cfg.n_layers):
        mlps.append({"w1": _dense(generator, (d_prev, cfg.d_hidden)),
                     "b1": _zeros(generator, cfg.d_hidden),
                     "w2": _dense(generator, (cfg.d_hidden, cfg.d_hidden)),
                     "b2": _zeros(generator, cfg.d_hidden)})
        d_prev = cfg.d_hidden
    return _placed({"mlps": mlps, "eps": _zeros(generator, cfg.n_layers),
                    "readout": _dense(generator,
                                      (cfg.d_hidden, cfg.n_classes))},
                   device)


def gin_forward(cfg: GINConfig, p: Params, batch) -> torch.Tensor:
    """Graph-level readout when ``graph_ids`` present, else node logits."""
    x, src, dst = batch["x"], batch["src"], batch["dst"]
    n1 = x.shape[0]
    for i, mlp in enumerate(p["mlps"]):
        agg = _seg_sum(_gather(x, src), dst, n1)
        h = (1.0 + p["eps"][i]) * x + agg
        h = F.relu(h @ mlp["w1"] + mlp["b1"])
        x = F.relu(h @ mlp["w2"] + mlp["b2"])
    if "graph_ids" in batch:
        gx = _seg_sum(x, batch["graph_ids"], batch["n_graphs"])
        return gx @ p["readout"]
    return x @ p["readout"]


# ---------------------------------------------------------------------------
# GAT [Veličković et al., arXiv:1710.10903]
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7
    negative_slope: float = 0.2


def gat_init(cfg: GATConfig, generator: torch.Generator,
             device="cuda") -> Params:
    layers = []
    d_prev = cfg.d_in
    for i in range(cfg.n_layers):
        last = i + 1 == cfg.n_layers
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        layers.append({
            "w": _dense(generator, (d_prev, heads * d_out)),
            "a_src": _dense(generator, (heads, d_out)),
            "a_dst": _dense(generator, (heads, d_out)),
        })
        d_prev = heads * d_out
    return _placed({"layers": layers}, device)


def gat_forward(cfg: GATConfig, p: Params, batch) -> torch.Tensor:
    x, src, dst = batch["x"], batch["src"], batch["dst"]
    n1 = x.shape[0]
    pad = batch.get("edge_pad")  # bool (E,), True = padding edge
    for i, lp in enumerate(p["layers"]):
        last = i + 1 == len(p["layers"])
        heads = 1 if last else cfg.n_heads
        d_out = lp["w"].shape[1] // heads
        h = (x @ lp["w"]).reshape(n1, heads, d_out)
        al = torch.einsum("nhd,hd->nh", h, lp["a_src"])
        ar = torch.einsum("nhd,hd->nh", h, lp["a_dst"])
        e = F.leaky_relu(_gather(al, src) + _gather(ar, dst),
                         cfg.negative_slope)  # (E, H)
        if pad is not None:
            e = torch.where(pad[:, None], -1e30, e)
        # the max stays in the graph, as the reference's: its gradient
        # cancels only up to rounding
        emax = _gather(_seg_max(e, dst, n1), dst)
        ex = torch.exp(e - emax)
        if pad is not None:
            ex = torch.where(pad[:, None], 0.0, ex)
        denom = _gather(torch.clamp(_seg_sum(ex, dst, n1), min=1e-9), dst)
        alpha = ex / denom  # (E, H) edge softmax (SDDMM -> segment softmax)
        msg = _gather(h, src) * alpha[:, :, None]
        out = _seg_sum(msg, dst, n1)  # (n1, H, d_out)
        x = out.reshape(n1, heads * d_out)
        if not last:
            x = F.elu(x)
    return x


# ---------------------------------------------------------------------------
# NequIP-class E(3)-equivariant network (Cartesian l_max = 2 realization)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class NequIPConfig:
    name: str
    n_layers: int = 5
    channels: int = 32
    l_max: int = 2  # 0: scalars, 1: +vectors, 2: +rank-2 traceless
    n_rbf: int = 8
    cutoff: float = 5.0
    d_in: int = 16  # species / input feature dim
    readout: str = "energy"  # energy (sum) | node (per-node scalar head)
    n_out: int = 1


def nequip_init(cfg: NequIPConfig, generator: torch.Generator,
                device="cuda") -> Params:
    C = cfg.channels
    g = generator
    p: Params = {"embed": _dense(g, (cfg.d_in, C))}
    layers = []
    n_paths = 6  # radial weights per message block (see nequip_forward)
    for _ in range(cfg.n_layers):
        layers.append({
            "radial_w1": _dense(g, (cfg.n_rbf, 32)),
            "radial_w2": _dense(g, (32, C * n_paths)),
            "mix_s": _dense(g, (C, C)),
            "mix_v": _dense(g, (C, C)),
            "mix_t": _dense(g, (C, C)),
            "gate_w": _dense(g, (3 * C, 2 * C)),
            "upd_w1": _dense(g, (3 * C, 2 * C)),
            "upd_w2": _dense(g, (2 * C, C)),
        })
    p["layers"] = layers
    p["out_w1"] = _dense(g, (C, C))
    p["out_w2"] = _dense(g, (C, cfg.n_out))
    return _placed(p, device)


def _rbf(dist: torch.Tensor, n_rbf: int, cutoff: float) -> torch.Tensor:
    mu = torch.linspace(0.0, cutoff, n_rbf, dtype=dist.dtype,
                        device=dist.device)
    gamma = n_rbf / cutoff
    basis = torch.exp(-gamma * torch.square(dist[:, None] - mu[None, :]))
    env = 0.5 * (torch.cos(math.pi * torch.clamp(dist / cutoff, 0, 1)) + 1.0)
    return basis * env[:, None]


def nequip_forward(cfg: NequIPConfig, p: Params, batch) -> torch.Tensor:
    """batch: pos (n+1, 3), x (n+1, d_in), src/dst (E,), optional
    graph_ids/n_graphs. Padding edges must connect the dummy node to
    itself (zero edge vector -> zero envelope contribution guarded)."""
    pos, src, dst = batch["pos"], batch["src"], batch["dst"]
    n1 = pos.shape[0]
    C = cfg.channels
    s = batch["x"] @ p["embed"]  # (n1, C) scalars
    v = s.new_zeros((n1, C, 3))
    t = s.new_zeros((n1, C, 3, 3))

    r = _gather(pos, src) - _gather(pos, dst)  # (E, 3)
    d = torch.sqrt(torch.sum(r * r, dim=-1) + 1e-12)
    u = r / d[:, None]
    rbf = _rbf(d, cfg.n_rbf, cfg.cutoff)  # (E, R)
    real = d > 1e-6  # padding edges have zero length
    eye = torch.eye(3, dtype=pos.dtype, device=pos.device)
    Y2 = u[:, :, None] * u[:, None, :] - eye[None] / 3.0  # (E, 3, 3)

    for lp in p["layers"]:
        w = F.silu(rbf @ lp["radial_w1"]) @ lp["radial_w2"]
        w = torch.where(real[:, None], w, 0.0).reshape(-1, C, 6)  # (E, C, 6)
        sj, vj, tj = _gather(s, src), _gather(v, src), _gather(t, src)
        # l-mixing message paths (Cartesian CG products, l <= 2):
        m_s = w[..., 0] * sj                                      # 0⊗0→0
        m_s = m_s + w[..., 1] * _einsum("eci,ei->ec", vj, u)  # 1⊗1→0
        m_v = w[..., 2, None] * vj                                 # 1⊗0→1
        m_v = m_v + w[..., 3, None] * sj[..., None] * u[:, None, :]  # 0⊗1→1
        m_v = m_v + w[..., 4, None] * _einsum("ecij,ej->eci", tj,
                                                   u)             # 2⊗1→1
        m_t = (w[..., 5, None, None] * sj[..., None, None]
               * Y2[:, None])                                     # 0⊗2→2
        agg_s = _seg_sum(m_s, dst, n1)
        agg_v = _seg_sum(m_v, dst, n1)
        agg_t = _seg_sum(m_t, dst, n1)
        # channel mixing (equivariant: acts on channel dim only)
        s_n = agg_s @ lp["mix_s"]
        v_n = _einsum("ncx,cd->ndx", agg_v, lp["mix_v"])
        t_n = _einsum("ncxy,cd->ndxy", agg_t, lp["mix_t"])
        # invariants -> gates
        inv = torch.cat(
            [s_n, torch.sum(v_n * v_n, -1),
             _einsum("ncxy,ncxy->nc", t_n, t_n)], dim=-1)  # (n1, 3C)
        gates = torch.sigmoid(inv @ lp["gate_w"]).reshape(n1, 2, C)
        upd = F.silu(inv @ lp["upd_w1"]) @ lp["upd_w2"]
        s = s + upd
        v = v + gates[:, 0][..., None] * v_n
        t = t + gates[:, 1][..., None, None] * t_n
    h = F.silu(s @ p["out_w1"]) @ p["out_w2"]  # (n1, n_out) invariant
    if cfg.readout == "energy" and "graph_ids" in batch:
        return _seg_sum(h, batch["graph_ids"], batch["n_graphs"])
    return h


# ---------------------------------------------------------------------------
# Unified entry points (used by configs and the smoke cells).
# ---------------------------------------------------------------------------

FORWARD = {"gcn": gcn_forward, "gin": gin_forward, "gat": gat_forward,
           "nequip": nequip_forward}
INIT = {"gcn": gcn_init, "gin": gin_init, "gat": gat_init,
        "nequip": nequip_init}


def node_ce_loss(kind, cfg, params, batch) -> torch.Tensor:
    logits = FORWARD[kind](cfg, params, batch)
    labels = batch["labels"].long()
    mask = batch.get("label_mask")
    if mask is None:
        mask = torch.ones(labels.shape[0], dtype=torch.bool,
                          device=labels.device)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, 1, labels[:, None])[:, 0]
    return torch.sum(torch.where(mask, logz - gold, 0.0)) / torch.clamp(
        torch.sum(mask), min=1)


def energy_mse_loss(cfg, params, batch) -> torch.Tensor:
    e = nequip_forward(cfg, params, batch)[:, 0]
    return torch.mean(torch.square(e - batch["energy"]))
