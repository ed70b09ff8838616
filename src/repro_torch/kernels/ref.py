"""Plain PyTorch versions of the three kernels (exact semantics).

The two products build the whole ``(nb, n, n2)`` candidate block, so they
are the oracles that the CUDA kernels are held against, not a path to run
at scale. The segment sum's is the sparse relaxations' CPU path.
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


def segment_sum_ref(cand, best, val, seg, *, count=False):
    """Plain version of the segment-sum kernel: ``index_add_`` of the
    tie-masked values, which on the CPU adds each segment's terms one at a
    time in index order, starting from 0 (``tests/test_torch_sparse.py``
    holds it to that order). cand/val: (nb, L); best: (nb, S); seg: (L,)
    int64 in [0, S], where S (the dump) takes no segment. Returns
    ``(out, count or None)``, each (nb, S)."""
    nb, n_seg = best.shape
    live = seg < n_seg
    tie = ((cand == best.index_select(1, torch.where(live, seg, 0)))
           & torch.isfinite(cand) & live)

    def total(x):
        out = torch.zeros((nb, n_seg + 1), dtype=x.dtype, device=x.device)
        return out.index_add_(1, seg, x)[:, :n_seg]

    return (total(torch.where(tie, val, 0.0)),
            total(tie.to(val.dtype)) if count else None)
