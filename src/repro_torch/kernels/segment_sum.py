"""The tie-masked segment sum of the COO and CSR relaxations, by device.

``segment_sum`` sends CUDA tensors to the Hopper kernel
``csrc/segment_sum.cu`` (design notes in the source) through
``segment_sum_cuda``, which launches or raises, and CPU tensors to the
plain version ``repro_torch.kernels.ref.segment_sum_ref``. Both add each
(row, segment)'s ties in ascending arc order, the order of the reference's
``jax.ops.segment_sum`` on the CPU, so a segment's sum depends on its own
terms only: not on the rows beside it, and not on exact zeros added by a
relax that touches more arcs. ``segment_sum_cuda.launches`` counts the
kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import segment_sum_ref

_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 2
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])
MAX_ROWS = 65535  # grid.y limit: one row of the batch per grid row


def segment_sum(cand: torch.Tensor, best: torch.Tensor, val: torch.Tensor,
                seg: torch.Tensor, offsets: torch.Tensor, *,
                count: bool = False):
    """Per (row, segment): the sum of ``val`` over the arcs of the segment
    whose candidate ties ``best`` (finite), and with ``count`` the number
    of such arcs.

    cand/val: (nb, L) float32 with the arcs grouped by segment, ``seg``
    (L,) int64 ascending and ``offsets`` (S+1,) its run bounds
    (``monoids.arc_runs``); best: (nb, S). Arcs with ``seg == S`` lie past
    ``offsets[S]`` and reduce into no segment. Returns ``(out, count or
    None)``, each (nb, S) float32.
    """
    if cand.is_cuda:
        return segment_sum_cuda(cand, best, val, offsets, count=count)
    if cand.device.type != "cpu":
        raise ValueError(f"segment_sum: no path for device {cand.device}")
    return segment_sum_ref(cand, best, val, seg, count=count)


def _check(cand, best, val, offsets) -> None:
    tensors = (cand, best, val, offsets)
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("segment_sum_cuda: the CUDA kernel takes CUDA "
                         "tensors only, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("segment_sum_cuda: operands on different devices")
    if any(t.dtype != torch.float32 for t in (cand, best, val)):
        raise ValueError("segment_sum_cuda: cand, best and val must be "
                         "float32")
    if offsets.dtype != torch.int64 or offsets.dim() != 1:
        raise ValueError("segment_sum_cuda: offsets must be 1-D int64")
    if (cand.dim() != 2 or best.dim() != 2 or cand.shape != val.shape
            or cand.shape[0] != best.shape[0]
            or offsets.shape[0] != best.shape[1] + 1):
        raise ValueError(
            "segment_sum_cuda: shapes "
            f"{[tuple(t.shape) for t in tensors]} are not (nb, L), (nb, S),"
            " (nb, L), (S + 1,)")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("segment_sum_cuda: operands must be contiguous")
    if cand.shape[0] > MAX_ROWS:
        raise ValueError(f"segment_sum_cuda: nb > {MAX_ROWS} overflows the "
                         "grid's y dimension")


def segment_sum_cuda(cand: torch.Tensor, best: torch.Tensor,
                     val: torch.Tensor, offsets: torch.Tensor, *,
                     count: bool = False):
    """``segment_sum`` on the card: one launch of ``csrc/segment_sum.cu``
    on the current stream. ``offsets`` must be non-decreasing; the kernel
    clamps each run to ``[0, L)``."""
    _check(cand, best, val, offsets)
    nb, n_seg = best.shape
    out = torch.empty((nb, n_seg), dtype=torch.float32, device=cand.device)
    cnt = torch.empty_like(out) if count else None
    if nb == 0 or n_seg == 0:
        return out, cnt
    fn = _build.function("segment_sum", _ARGTYPES)
    rc = fn(cand.data_ptr(), best.data_ptr(), val.data_ptr(),
            offsets.data_ptr(), out.data_ptr(),
            None if cnt is None else cnt.data_ptr(), nb, n_seg,
            cand.shape[1], cand.device.index,
            torch.cuda.current_stream(cand.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_sum launch failed: cudaError {rc}")
    segment_sum_cuda.launches += 1
    return out, cnt


segment_sum_cuda.launches = 0
