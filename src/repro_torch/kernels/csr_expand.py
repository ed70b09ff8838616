"""Wrapper for the Hopper CSR arc expansion (the pre-sort arrays of a CSR
relax's runs).

``csr_expand_cuda`` launches ``csrc/csr_expand.cu`` (design notes in the
source) on CUDA tensors and nothing else: it checks device, dtype, shape
and contiguity, allocates the three outputs, launches on the current
stream, raises if the launch fails, and counts its launches in
``csr_expand_cuda.launches`` and in the ``csr_expand.launch`` counter of
``repro_torch.tracing``. A length of 0 launches nothing. Its plain PyTorch
version is ``repro_torch.core.monoids._expand_arcs``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 2 + [ctypes.c_longlong]
             + [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2
             + [ctypes.c_void_p] * 3 + [ctypes.c_int, ctypes.c_void_p])
LAUNCH_COUNTER = "csr_expand.launch"


def _count_launch() -> None:
    csr_expand_cuda.launches += 1
    tracing.count(LAUNCH_COUNTER)


def _check(u, offs, indptr, seg, w, length) -> None:
    tensors = (u, offs, indptr, seg, w)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("csr_expand_cuda: the CUDA kernel takes CUDA "
                         "tensors only, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("csr_expand_cuda: operands on different devices")
    if (any(t.dim() != 1 for t in tensors) or offs.shape != u.shape
            or u.shape[0] < 1 or w.shape != seg.shape):
        raise ValueError(
            "csr_expand_cuda: shapes "
            f"{[tuple(t.shape) for t in tensors]} are not (m,), (m,), "
            "(n + 1,), (E,), (E,) with m >= 1")
    if (u.dtype, offs.dtype, indptr.dtype, seg.dtype) != (torch.int64,) * 4:
        raise ValueError("csr_expand_cuda: u, offs, indptr and seg must be "
                         "int64")
    if w.dtype != torch.float32:
        raise ValueError("csr_expand_cuda: w must be float32")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("csr_expand_cuda: operands must be contiguous")
    if length < 0:
        raise ValueError(f"csr_expand_cuda: length {length} < 0")


def csr_expand_cuda(u: torch.Tensor, offs: torch.Tensor, indptr: torch.Tensor,
                    seg: torch.Tensor, w: torch.Tensor, n: int, length: int):
    """The first ``length`` arc slots of the compacted columns ``u`` (m,)
    with degree cumsum ``offs`` (m,) over the CSR side ``indptr``, ``seg``,
    ``w``: returns ``(key, col, w)``, (length,) int64, int64, float32,
    bitwise the first ``length`` slots of ``monoids._expand_arcs``. Slots
    at or past ``offs[-1]`` are dead (key ``n``, w +inf)."""
    _check(u, offs, indptr, seg, w, length)
    dev = u.device
    key = torch.empty(length, dtype=torch.int64, device=dev)
    col = torch.empty(length, dtype=torch.int64, device=dev)
    out = torch.empty(length, dtype=torch.float32, device=dev)
    if length == 0:
        return key, col, out
    fn = _build.function("csr_expand", _ARGTYPES)
    rc = fn(u.data_ptr(), offs.data_ptr(), u.shape[0], indptr.data_ptr(),
            seg.data_ptr(), w.data_ptr(), int(n), int(length),
            key.data_ptr(), col.data_ptr(), out.data_ptr(), dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"csr_expand launch failed: cudaError {rc}")
    _count_launch()
    return key, col, out


csr_expand_cuda.launches = 0
