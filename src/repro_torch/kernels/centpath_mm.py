"""Wrapper for the Hopper centpath kernel (the MFBr Brandes action).

``centpath_matmul_cuda`` launches ``csrc/centpath_mm.cu`` (design notes in
the source) on CUDA tensors and nothing else, with the same checks as
``tropical_mm.multpath_matmul_cuda``, and counts its launches in
``centpath_matmul_cuda.launches``. Its plain PyTorch version is
``repro_torch.kernels.ref.centpath_matmul_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.tropical_mm import check_operands

_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def centpath_matmul_cuda(fw: torch.Tensor, fp: torch.Tensor, b: torch.Tensor):
    """fw/fp: (nb, n); b: (n, n2) (= Aᵀ), float32 on one CUDA device.

    Returns (cw, cp, cc): (nb, n2) with ``cw = max_k fw[:, k] - b[k]``
    (inactive or no edge -> -inf) and the tie-summed ``cp`` and counts
    ``cc``.
    """
    check_operands((fw, fp), b, "centpath_matmul_cuda")
    nb, n = fw.shape
    n2 = b.shape[1]
    cw = torch.empty((nb, n2), dtype=torch.float32, device=fw.device)
    cp = torch.empty((nb, n2), dtype=torch.float32, device=fw.device)
    cc = torch.empty((nb, n2), dtype=torch.float32, device=fw.device)
    if nb == 0 or n2 == 0:
        return cw, cp, cc
    fn = _build.function("centpath_mm", _ARGTYPES)
    rc = fn(fw.data_ptr(), fp.data_ptr(), b.data_ptr(), cw.data_ptr(),
            cp.data_ptr(), cc.data_ptr(), nb, n, n2, fw.device.index,
            torch.cuda.current_stream(fw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"centpath_mm launch failed: cudaError {rc}")
    centpath_matmul_cuda.launches += 1
    return cw, cp, cc


centpath_matmul_cuda.launches = 0
