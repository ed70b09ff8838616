"""Public entry points of the two products, dispatched by device.

A CUDA tensor goes to the Hopper kernel (``tropical_mm`` / ``centpath_mm``),
which launches or raises; there is no fallback. A CPU tensor goes to the
plain PyTorch version, the blocked k-scan of ``repro_torch.core.monoids``
with ``_pick_block`` choosing the k-block. The kernels mask ragged edges
themselves, so nothing is padded on either path. ``splits`` fixes the
kernels' contraction split count (``tropical_mm.resolve_splits``); the plain
path has no slices and ignores it.
"""
from __future__ import annotations

import torch

from repro_torch.core import monoids
from repro_torch.core.monoids import Centpath, Multpath
from repro_torch.kernels.centpath_mm import centpath_matmul_cuda
from repro_torch.kernels.tropical_mm import multpath_matmul_cuda

K_BLOCK = 128  # preferred k-block of the plain CPU path


def _pick_block(dim: int, pref: int) -> int:
    """Largest power-of-two block <= pref that keeps padding sane."""
    b = pref
    while b > 8 and dim < b // 2:
        b //= 2
    return b


def _check_cpu(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"{what}: no path for device {t.device}")


def multpath_matmul(fw: torch.Tensor, fm: torch.Tensor, a: torch.Tensor,
                    splits=None):
    """Multpath product. fw/fm: (nb, n); a: (n, n2). Returns (cw, cm)."""
    if fw.is_cuda:
        return multpath_matmul_cuda(fw, fm, a, splits)
    _check_cpu(fw, "multpath_matmul")
    C = monoids.multpath_relax_dense(Multpath(fw, fm), a,
                                     block=_pick_block(fw.shape[1], K_BLOCK))
    return C.w, C.m


def centpath_matmul(fw: torch.Tensor, fp: torch.Tensor, b: torch.Tensor,
                    splits=None):
    """Centpath product. fw/fp: (nb, n); b: (n, n2) (= Aᵀ).
    Returns (cw, cp, cc)."""
    if fw.is_cuda:
        return centpath_matmul_cuda(fw, fp, b, splits)
    _check_cpu(fw, "centpath_matmul")
    C = monoids.centpath_relax_dense(Centpath(fw, fp, None), b,
                                     block=_pick_block(fw.shape[1], K_BLOCK))
    return C.w, C.p, C.c
