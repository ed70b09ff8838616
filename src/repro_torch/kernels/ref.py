"""Plain PyTorch versions of the three kernels (exact semantics).

The two products build the whole ``(nb, n, n2)`` candidate block, so they
are the oracles that the CUDA kernels are held against, not a path to run
at scale. The sparse relax's (``*_segment_relax_ref``) is the COO and CSR
relaxations' CPU path.
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
    """The sparse relax's tie sums: ``index_add_`` of the tie-masked
    values, which on the CPU adds each segment's terms one at a
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


def _segment_extreme(cand, seg, n, how):
    """Per-(row, segment) amin/amax of ``cand`` (nb, L) over ``seg`` (L,):
    exact in any order. An empty segment keeps the identity (±inf); column
    n is the dump of the dead slots and is dropped."""
    init = INF if how == "amin" else -INF
    out = torch.full((cand.shape[0], n + 1), init, dtype=cand.dtype,
                     device=cand.device)
    out.scatter_reduce_(1, seg.expand_as(cand), cand, how, include_self=True)
    return out[:, :n].contiguous()


def multpath_segment_relax_ref(fw, fm, col, seg, w):
    """Plain version of the MFBF sparse relax: fw/fm (nb, n); the arcs
    grouped by ``seg`` (L,) in [0, n] (n = dead), reading columns ``col``
    with weights ``w``. Returns ``(w, m)``, each (nb, n)."""
    n = fw.shape[1]
    cand = fw.index_select(1, col) + w  # (nb, L)
    minw = _segment_extreme(cand, seg, n, "amin")
    m, _ = segment_sum_ref(cand, minw, fm.index_select(1, col), seg)
    # an empty segment keeps minw = inf already; entries whose ties sum to
    # zero multiplicity are inactive too
    return torch.where(m > 0, minw, INF), m


def centpath_segment_relax_ref(fw, fp, col, seg, w):
    """Plain version of the MFBr sparse relax. Returns ``(w, p, c)``."""
    n = fw.shape[1]
    g = fw.index_select(1, col)
    cand = torch.where(torch.isfinite(g) & torch.isfinite(w), g - w, -INF)
    maxw = _segment_extreme(cand, seg, n, "amax")
    p, c = segment_sum_ref(cand, maxw, fp.index_select(1, col), seg,
                           count=True)
    return torch.where(c > 0, maxw, -INF), p, c
