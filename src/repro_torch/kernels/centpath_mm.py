"""Wrapper for the Hopper centpath kernel (the MFBr Brandes action).

``centpath_matmul_cuda`` launches ``csrc/centpath_mm.cu`` (design notes in
the source) on CUDA tensors and nothing else, with the same checks, split
count, scratch and live-k packing (``live_k``) as
``tropical_mm.multpath_matmul_cuda``, and counts its
launches in ``centpath_matmul_cuda.launches``. Its plain PyTorch version
is ``repro_torch.kernels.ref.centpath_matmul_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build, live_k
from repro_torch.kernels.tropical_mm import (check_operands, resolve_splits,
                                             scratch_ptr)

_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])


def centpath_launch(fw: torch.Tensor, fp: torch.Tensor, b: torch.Tensor,
                    splits: int):
    """Pack F's live columns and launch ``csrc/centpath_mm.cu`` over them
    with ``splits`` contraction slices, on operands that ``check_operands``
    passed, nb and n2 > 0. Counts no launch (``centpath_matmul_cuda``
    is the entry point); records the contraction's k and live k while the
    profiler runs (``live_k.count_contraction``)."""
    nb, n = fw.shape
    n2 = b.shape[1]
    f = live_k.live_k_cuda(fw, fp, splits, finite=True)
    cw, cp, cc = (torch.empty((nb, n2), dtype=torch.float32,
                              device=fw.device) for _ in range(3))
    part, part_ptr = scratch_ptr(fw, n2, 3, splits)
    fn = _build.function("centpath_mm", _ARGTYPES)
    rc = fn(f.w.data_ptr(), f.x.data_ptr(), b.data_ptr(), f.idx.data_ptr(),
            f.counts.data_ptr(), cw.data_ptr(), cp.data_ptr(), cc.data_ptr(),
            part_ptr, nb, n, n2, splits, fw.device.index,
            torch.cuda.current_stream(fw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"centpath_mm launch failed: cudaError {rc}")
    live_k.count_contraction("centpath_mm", n, f.counts)
    return cw, cp, cc


def centpath_matmul_cuda(fw: torch.Tensor, fp: torch.Tensor, b: torch.Tensor,
                         splits=None):
    """fw/fp: (nb, n); b: (n, n2) (= Aᵀ), float32 on one CUDA device.

    Returns (cw, cp, cc): (nb, n2) with ``cw = max_k fw[:, k] - b[k]``
    (inactive or no edge -> -inf) and the tie-summed ``cp`` and counts
    ``cc``. The contraction is split into ``splits`` slices, by default
    ``pick_splits``' choice (``tropical_mm.resolve_splits``).
    """
    check_operands((fw, fp), b, "centpath_matmul_cuda")
    nb, n = fw.shape
    n2 = b.shape[1]
    if nb == 0 or n2 == 0:
        return tuple(torch.empty((nb, n2), dtype=torch.float32,
                                 device=fw.device) for _ in range(3))
    out = centpath_launch(fw, fp, b,
                          resolve_splits(splits, nb, n, n2, fw.device))
    centpath_matmul_cuda.launches += 1
    return out


centpath_matmul_cuda.launches = 0
