"""Wrapper for the Hopper multpath kernel (the MFBF Bellman-Ford action).

``multpath_matmul_cuda`` launches ``csrc/multpath_mm.cu`` (design notes in
the source) on CUDA tensors and nothing else: it checks device, dtype,
shape and contiguity, allocates the outputs, launches on the current
stream, raises if the launch fails, and counts its launches in
``multpath_matmul_cuda.launches``. Its plain PyTorch version is
``repro_torch.kernels.ref.multpath_matmul_ref``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

_ARGTYPES = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
MAX_ROWS = 65535 * 32  # grid.y limit times the kernels' 32-row tiles


def check_operands(f_pair, b: torch.Tensor, what: str) -> None:
    """Raise ValueError unless ``f_pair`` are two (nb, n) and ``b`` one
    (n, n2) contiguous float32 tensors on one CUDA device."""
    tensors = (*f_pair, b)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError(f"{what}: the CUDA kernel takes CUDA tensors only, "
                         f"got {[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"{what}: operands on different devices")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{what}: float32 only, got "
                         f"{[t.dtype for t in tensors]}")
    if any(t.dim() != 2 for t in tensors):
        raise ValueError(f"{what}: 2-D operands only")
    if f_pair[0].shape != f_pair[1].shape or f_pair[0].shape[1] != b.shape[0]:
        raise ValueError(f"{what}: shapes {[tuple(t.shape) for t in tensors]}"
                         " do not chain as (nb, n), (nb, n), (n, n2)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{what}: operands must be contiguous")
    if f_pair[0].shape[0] > MAX_ROWS:
        raise ValueError(f"{what}: nb > {MAX_ROWS} overflows the grid's "
                         "y dimension")


def multpath_matmul_cuda(fw: torch.Tensor, fm: torch.Tensor, a: torch.Tensor):
    """fw/fm: (nb, n); a: (n, n2), float32 on one CUDA device.

    Returns (cw, cm): (nb, n2) with ``cw = min_k fw[:, k] + a[k]`` and
    ``cm`` the tie-summed multiplicities.
    """
    check_operands((fw, fm), a, "multpath_matmul_cuda")
    nb, n = fw.shape
    n2 = a.shape[1]
    cw = torch.empty((nb, n2), dtype=torch.float32, device=fw.device)
    cm = torch.empty((nb, n2), dtype=torch.float32, device=fw.device)
    if nb == 0 or n2 == 0:
        return cw, cm
    fn = _build.function("multpath_mm", _ARGTYPES)
    rc = fn(fw.data_ptr(), fm.data_ptr(), a.data_ptr(), cw.data_ptr(),
            cm.data_ptr(), nb, n, n2, fw.device.index,
            torch.cuda.current_stream(fw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multpath_mm launch failed: cudaError {rc}")
    multpath_matmul_cuda.launches += 1
    return cw, cm


multpath_matmul_cuda.launches = 0
