"""Plain PyTorch versions of the two kernels (exact semantics, naive memory).

Each builds the whole ``(nb, n, n2)`` candidate block, so they are the
oracles that the CUDA kernels are held against, not a path to run at scale.
"""
from __future__ import annotations

import torch

INF = float("inf")


def multpath_matmul_ref(fw, fm, a):
    """Naive O(nb·n·n2)-memory reference for the multpath kernel."""
    cand = fw[:, :, None] + a[None, :, :]  # (nb, n, n2)
    cw = cand.amin(dim=1)
    tie = (cand == cw[:, None, :]) & torch.isfinite(cand)
    cm = torch.where(tie, fm[:, :, None], 0.0).sum(dim=1)
    return cw, cm


def centpath_matmul_ref(fw, fp, b):
    """Naive reference for the centpath kernel."""
    cand = fw[:, :, None] - b[None, :, :]
    cand = torch.where(torch.isfinite(fw)[:, :, None]
                       & torch.isfinite(b)[None, :, :], cand, -INF)
    cw = cand.amax(dim=1)
    tie = (cand == cw[:, None, :]) & torch.isfinite(cand)
    cp = torch.where(tie, fp[:, :, None], 0.0).sum(dim=1)
    cc = tie.sum(dim=1, dtype=fw.dtype)
    return cw, cp, cc
