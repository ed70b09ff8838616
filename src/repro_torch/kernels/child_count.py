"""Wrapper for the Hopper SP-DAG child count (the dense count that starts
MFBr).

``child_count_cuda`` launches ``csrc/child_count.cu`` (design notes in the
source) on CUDA tensors and nothing else: it checks device, dtype, shape
and contiguity, allocates the int32 output, picks the split count
(``tropical_mm.resolve_splits``), launches on the current stream, raises if
the launch fails, and counts its launches in ``child_count_cuda.launches``
and in the ``child_count.launch`` counter of ``repro_torch.tracing``. Its
plain PyTorch version is ``repro_torch.core.monoids.count_sp_children_dense``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch import tracing
from repro_torch.kernels import _build
from repro_torch.kernels.tropical_mm import check_operands, resolve_splits

_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
LAUNCH_COUNTER = "child_count.launch"


def _count_launch() -> None:
    child_count_cuda.launches += 1
    tracing.count(LAUNCH_COUNTER)


def child_count_cuda(tw: torch.Tensor, at: torch.Tensor,
                     splits=None) -> torch.Tensor:
    """tw: (nb, n) distances; at: (n, n) = Aᵀ, float32 on one CUDA device.

    Returns (nb, n) int32 ``c0[s, v] = #{u : tw[s, v] + at[u, v] ==
    tw[s, u], finite}``, bitwise ``count_sp_children_dense(tw, at.T)``. The
    contraction over u is split into ``splits`` slices, by default
    ``pick_splits``' choice for this shape and card; every split count
    gives the same counts.
    """
    check_operands((tw, tw), at, "child_count_cuda")
    nb, n = tw.shape
    if at.shape[1] != n:
        raise ValueError(f"child_count_cuda: Aᵀ must be ({n}, {n}), got "
                         f"{tuple(at.shape)}")
    if nb == 0 or n == 0:
        return torch.zeros((nb, n), dtype=torch.int32, device=tw.device)
    s = resolve_splits(splits, nb, n, n, tw.device)
    out = torch.empty((nb, n), dtype=torch.int32, device=tw.device)
    fn = _build.function("child_count", _ARGTYPES)
    rc = fn(tw.data_ptr(), at.data_ptr(), out.data_ptr(), nb, n, s,
            tw.device.index, torch.cuda.current_stream(tw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"child_count launch failed: cudaError {rc}")
    _count_launch()
    return out


child_count_cuda.launches = 0
