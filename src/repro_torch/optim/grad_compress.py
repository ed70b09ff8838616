"""Gradient compression with error feedback, applied before the DP
all-reduce.

A port of ``repro/optim/grad_compress.py``. Two compressors:

* ``topk``  — per-leaf magnitude top-k sparsification (k = ratio·size);
  the residual (what was dropped) is carried in an error-feedback buffer
  and added back next step [1-bit SGD / Deep Gradient Compression lineage].
* ``int8``  — per-leaf symmetric int8 quantization with fp32 scale;
  error feedback likewise.

A leaf is a leaf of the reference's tree: the LM's layer parameters are
stacked on dim 0, so ``topk`` picks k over all layers of a stacked leaf
and ``int8`` takes one scale over it. ``compress`` returns the
decompressed-equivalent gradient (what the optimizer consumes after the
all-reduce), the new error buffer and the bytes of the compressed wire
form (the sparse (values, indices) pair, or the int8 payload and its
scale).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import tree as tree_lib


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    kind: str = "topk"  # topk | int8 | none
    topk_ratio: float = 0.01


def init_error(params):
    return tree_lib.tree_map(
        lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device),
        params)


def _topk_leaf(g, err, ratio):
    g = g.float() + err
    flat = g.reshape(-1)
    k = max(1, int(flat.numel() * ratio))
    _, idx = torch.topk(torch.abs(flat), k)
    vals = flat[idx]
    kept = torch.zeros_like(flat).index_copy_(0, idx, vals).reshape(g.shape)
    return kept, g - kept, (vals, idx)


def _int8_leaf(g, err):
    g = g.float() + err
    scale = torch.clamp(torch.amax(torch.abs(g)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    deq = q.float() * scale
    return deq, g - deq, (q, scale)


def compress(cfg: CompressConfig, grads, err):
    """Returns (dense_payload, new_err, wire_bytes_estimate)."""
    if cfg.kind == "none":
        bytes_ = sum(g.numel() * 4 for _, g in tree_lib.leaves(grads))
        return grads, err, bytes_

    errs = dict(tree_lib.leaves(err))
    dense, new_err = [], []
    wire = 0
    with torch.no_grad():
        for path, g in tree_lib.leaves(grads):
            if cfg.kind == "topk":
                kept, new_e, (vals, idx) = _topk_leaf(g, errs[path],
                                                      cfg.topk_ratio)
                wire += vals.numel() * 4 + idx.numel() * 4
            elif cfg.kind == "int8":
                kept, new_e, (q, _) = _int8_leaf(g, errs[path])
                wire += q.numel() + 4
            else:
                raise ValueError(cfg.kind)
            dense.append((path, kept))
            new_err.append((path, new_e))
    return tree_lib.unflatten(dense), tree_lib.unflatten(new_err), wire


def compression_ratio(cfg: CompressConfig, params) -> float:
    if cfg.kind == "topk":
        return cfg.topk_ratio * 2  # values + indices
    if cfg.kind == "int8":
        return 0.25
    return 1.0
