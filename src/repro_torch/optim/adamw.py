"""AdamW optimizer (from scratch, no ``torch.optim``).

A port of ``repro/optim/adamw.py``. Optimizer state is a tree mirroring
the parameters (nested dicts of tensors, the reference's layout), so a
train state checkpoints in the reference's format. Includes global-norm
gradient clipping and a linear-warmup + cosine schedule.

``update`` works in place: the moments and the parameters are written
into their own tensors and returned, and each gradient is dropped from
``grads`` once its leaf is updated, so its memory frees before the next
leaf's temporaries. It is the port's counterpart of the reference's
donated state (``donate=(0, 1)``): a functional update would hold the
old and the new parameters and moments together. The arithmetic is the
reference's, in its order of operations.

``abstract_state`` gives the state of abstract parameters
(``sharding.abstract``: fake or meta, DTensors under a mesh), each moment
placed as its parameter (``_shard_like``). ``_is_q8`` has no
counterpart: the update walks the parameters' paths, so an int8
moment's ``{"q", "s"}`` dict needs no leaf predicate.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Tuple

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_frac: float = 0.1
    # "f32" or "int8" — compressed moments: m in int8 with per-row absmax
    # scales (sign-symmetric, quantizes well), v in bf16 (g² has squared
    # dynamic range — linear int8 underflows it to zero and explodes the
    # update, so v keeps bf16's exponent range). 8+16 bits vs 64: ~2.7x
    # optimizer-state reduction.
    moment_dtype: str = "f32"


def _q8(x: torch.Tensor) -> dict:
    """Quantize to int8 with per-leading-dim absmax scales."""
    if x.ndim == 0:
        return {"q": x.float(), "s": torch.ones((), dtype=torch.float32,
                                                device=x.device)}
    # a 1-D leaf gets a scale an element (``torch.amax`` over ``dim=()``
    # would reduce over every dim)
    red = tuple(range(1, x.ndim))
    s = (torch.amax(torch.abs(x), dim=red, keepdim=True) if red
         else torch.abs(x)) / 127.0
    s = torch.clamp(s, min=1e-12)
    return {"q": torch.clamp(torch.round(x / s), -127, 127).to(torch.int8),
            "s": s.float()}


def _dq8(t: dict) -> torch.Tensor:
    if t["q"].dtype != torch.int8:
        return t["q"]
    return t["q"].float() * t["s"]


def _zeros(p: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Contiguous zeros of ``p``'s shape on its device (a DTensor's: a
    DTensor placed as ``p``)."""
    return torch.zeros_like(p, dtype=dtype,
                            memory_format=torch.contiguous_format)


def init_state(params, moment_dtype: str = "f32") -> dict:
    """Zero moments and step 0, on the parameters' device (placed as the
    parameters when they are DTensors)."""
    dev = tree_lib.leaves(params)[0][1].device
    if moment_dtype == "int8":
        m = tree_lib.tree_map(lambda p: _q8(_zeros(p, torch.float32)),
                              params)
        v = tree_lib.tree_map(lambda p: _zeros(p, torch.bfloat16), params)
    else:
        m = tree_lib.tree_map(lambda p: _zeros(p, torch.float32), params)
        v = tree_lib.tree_map(lambda p: _zeros(p, torch.float32), params)
    return {"m": m, "v": v,
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def _shard_like(p: torch.Tensor, shape, dtype: torch.dtype,
                like: bool = True) -> torch.Tensor:
    """An uninitialized tensor of ``shape`` on ``p``'s device: a DTensor
    ``p``'s is placed as ``p`` (``like``, the ranks matching) or
    replicated on its mesh."""
    from torch.distributed.tensor import DTensor, Replicate

    from repro_torch.sharding.rules import Sharding, abstract

    if not isinstance(p, DTensor):
        return torch.empty(shape, dtype=dtype, device=p.device)
    mesh = p.device_mesh
    pl = (tuple(p.placements) if like and len(shape) == p.ndim
          else (Replicate(),) * mesh.ndim)
    return abstract(shape, dtype, Sharding(mesh, pl),
                    p.to_local().device)


def abstract_state(abstract_params, moment_dtype: str = "f32") -> dict:
    """``init_state``'s layout for abstract parameters, uninitialized:
    each moment placed as its parameter, an int8 moment's scales
    replicated (as the reference's), ``step`` a plain scalar."""
    if moment_dtype == "int8":
        def mk8(p):
            sshape = (p.shape[0],) + (1,) * (len(p.shape) - 1) if p.shape \
                else ()
            return {"q": _shard_like(p, p.shape, torch.int8),
                    "s": _shard_like(p, sshape, torch.float32, like=False)}

        m = tree_lib.tree_map(mk8, abstract_params)
        v = tree_lib.tree_map(
            lambda p: _shard_like(p, p.shape, torch.bfloat16),
            abstract_params)
    else:
        m = tree_lib.tree_map(
            lambda p: _shard_like(p, p.shape, torch.float32),
            abstract_params)
        v = tree_lib.tree_map(
            lambda p: _shard_like(p, p.shape, torch.float32),
            abstract_params)
    first = tree_lib.leaves(abstract_params)[0][1]
    dev = first.to_local().device if hasattr(first, "to_local") \
        else first.device
    return {"m": m, "v": v,
            "step": torch.empty((), dtype=torch.int32, device=dev)}


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor), in f32."""
    warm = torch.clamp((step + 1) / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + torch.cos(math.pi * t))
    return cfg.lr * warm * cos


def global_norm(tree) -> torch.Tensor:
    """sqrt of the sum over leaves (in sorted key order) of each leaf's
    sum of squares, in f32."""
    total = 0
    for _, g in tree_lib.leaves(tree):
        total = total + torch.sum(torch.square(g.float()))
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm: float):
    """Scales ``grads`` in place to a global norm of at most ``max_norm``;
    returns ``(grads, norm)`` with the norm before clipping."""
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    with torch.no_grad():
        for _, g in tree_lib.leaves(grads):
            g.mul_(scale)
    return grads, norm


def _pop(tree, path) -> Any:
    """The leaf at ``path``, dropped from ``tree`` (a list keeps its
    length: the slot is set to None)."""
    for k in path[:-1]:
        tree = tree[k]
    leaf = tree[path[-1]]
    tree[path[-1]] = None
    return leaf


def _at(tree, path) -> Any:
    for k in path:
        tree = tree[k]
    return tree


def update(cfg: AdamWConfig, grads, state, params) -> Tuple[Any, dict, dict]:
    """One AdamW step. Returns ``(params, state, metrics)``: ``params`` and
    ``state`` are the arguments themselves, updated in place; ``grads``
    (a tree of ``params``' structure) is clipped in place and consumed,
    each leaf removed once used."""
    step = state["step"]
    gnorm = torch.zeros((), dtype=torch.float32, device=step.device)
    if cfg.grad_clip is not None:
        grads, gnorm = clip_by_global_norm(grads, cfg.grad_clip)
    lr = schedule(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    q8 = cfg.moment_dtype == "int8"
    t = step.float() + 1.0
    mhat_scale = 1.0 / (1 - b1 ** t)
    vhat_scale = 1.0 / (1 - b2 ** t)
    with torch.no_grad():
        for path, p in tree_lib.leaves(params):
            g = _pop(grads, path).float()
            m, v = _at(state["m"], path), _at(state["v"], path)
            # m = b1·m + (1 − b1)·g; v = b2·v + (1 − b2)·g²
            if q8:
                new = _q8((_dq8(m) * b1).add_((1 - b1) * g))
                m["q"].copy_(new["q"])
                m["s"].copy_(new["s"])
                del new
                vf = v.float().mul_(b2).add_((1 - b2) * torch.square(g))
                v.copy_(vf)  # rounds to bf16
                del vf
            else:
                m.mul_(b1).add_((1 - b1) * g)
                v.mul_(b2).add_((1 - b2) * torch.square(g))
            del g
            # p − lr·(m̂ / (sqrt(v̂) + eps) + wd·p)
            delta = _dq8(m) * mhat_scale if q8 else m * mhat_scale
            den = v.float() * vhat_scale if q8 else v * vhat_scale
            delta.div_(den.sqrt_().add_(cfg.eps))
            del den
            if cfg.weight_decay:
                delta.add_(cfg.weight_decay * p.float())
            p.sub_(delta.mul_(lr))
            del delta
        step.add_(1)
    return params, state, {"lr": lr, "grad_norm": gnorm}
