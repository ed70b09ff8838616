"""The sparse relax of the COO and CSR backends, by device.

``multpath_segment_relax`` / ``centpath_segment_relax`` take F's two
fields (nb, n) and the arcs grouped into runs (``monoids.Runs``: ``col``,
``seg``, ``w``, ``offsets``) and return the relax's fields (nb, n): the
gather of F, the per-run min (MFBF) or max (MFBr) and the tie sums in arc
order. CUDA tensors go to the Hopper kernel ``csrc/segment_relax.cu``
(design notes in the source) through ``segment_relax_cuda``, which
launches or raises; CPU tensors go to the plain versions in
``repro_torch.kernels.ref`` (``index_select``, ``scatter_reduce_`` and the
ordered ``index_add_``). Both add each (row, run)'s ties one at a time in
ascending arc order, the order of the reference's ``jax.ops.segment_sum``
on the CPU. ``segment_relax_cuda.launches`` counts the kernel's launches.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import (centpath_segment_relax_ref,
                                     multpath_segment_relax_ref)

_ARGTYPES = ([ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int]
             + [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
             + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                ctypes.c_void_p])
# Runs longer than this take a block each, shorter ones a group of lanes.
LONG_RUN = 256
_INT_MAX = 2 ** 31 - 1


def multpath_segment_relax(fw, fm, col, seg, w, offsets):
    """MFBF over runs grouped by ``dst``: returns ``(w, m)``, each (nb, n)."""
    if fw.is_cuda:
        return segment_relax_cuda(fw, fm, col, w, offsets, centpath=False)
    _check_cpu(fw)
    return multpath_segment_relax_ref(fw, fm, col, seg, w)


def centpath_segment_relax(fw, fp, col, seg, w, offsets):
    """MFBr over runs grouped by ``src``: returns ``(w, p, c)``."""
    if fw.is_cuda:
        return segment_relax_cuda(fw, fp, col, w, offsets, centpath=True)
    _check_cpu(fw)
    return centpath_segment_relax_ref(fw, fp, col, seg, w)


def _check_cpu(t: torch.Tensor) -> None:
    if t.device.type != "cpu":
        raise ValueError(f"segment_relax: no path for device {t.device}")


def _check(fw, f2, col, w, offsets, threshold) -> None:
    tensors = (fw, f2, col, w, offsets)
    if (fw.dim() != 2 or f2.shape != fw.shape or col.dim() != 1
            or w.shape != col.shape or offsets.dim() != 1
            or offsets.shape[0] != fw.shape[1] + 1):
        raise ValueError(
            "segment_relax_cuda: shapes "
            f"{[tuple(t.shape) for t in tensors]} are not (nb, n), (nb, n),"
            " (L,), (L,), (n + 1,)")
    if (fw.dtype, f2.dtype, w.dtype) != (torch.float32,) * 3:
        raise ValueError("segment_relax_cuda: F's fields and w must be "
                         "float32")
    if (col.dtype, offsets.dtype) != (torch.int64,) * 2:
        raise ValueError("segment_relax_cuda: col and offsets must be int64")
    if fw.shape[1] > _INT_MAX or threshold < 0:
        raise ValueError("segment_relax_cuda: n must fit an int and the "
                         "threshold be >= 0")
    if any(t.device.type != "cuda" for t in tensors):
        raise ValueError("segment_relax_cuda: the CUDA kernel takes CUDA "
                         "tensors only, got "
                         f"{[str(t.device) for t in tensors]}")
    if len({t.device for t in tensors}) != 1:
        raise ValueError("segment_relax_cuda: operands on different devices")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("segment_relax_cuda: operands must be contiguous")


def segment_relax_cuda(fw, f2, col, w, offsets, *, centpath: bool,
                       threshold: int = LONG_RUN):
    """The relax on the card: one call of ``csrc/segment_relax.cu`` on the
    current stream (a transpose-and-bin pass, then the relax). ``f2`` is
    F.m (MFBF) or F.p (MFBr); runs longer than ``threshold`` arcs take a
    block each. ``offsets`` must be non-decreasing and ``col`` lie in
    [0, n); the kernel clamps each run to [0, L). Returns ``(w, m)`` or
    ``(w, p, c)``."""
    _check(fw, f2, col, w, offsets, threshold)
    nb, n = fw.shape
    dev = fw.device
    outs = tuple(torch.empty((nb, n), dtype=torch.float32, device=dev)
                 for _ in range(3 if centpath else 2))
    if nb == 0 or n == 0:
        return outs
    length = col.shape[0]
    cap = min(n, length // (threshold + 1))  # runs longer than threshold
    g = torch.empty((2, n, nb), dtype=torch.float32, device=dev)
    lst = torch.empty(3 + cap, dtype=torch.int32, device=dev)
    fn = _build.function("segment_relax", _ARGTYPES)
    rc = fn(int(centpath), fw.data_ptr(), f2.data_ptr(), col.data_ptr(),
            w.data_ptr(), offsets.data_ptr(), g.data_ptr(), lst.data_ptr(),
            cap, outs[0].data_ptr(), outs[1].data_ptr(),
            outs[2].data_ptr() if centpath else None, nb, n, length,
            threshold, dev.index,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"segment_relax launch failed: cudaError {rc}")
    segment_relax_cuda.launches += 1
    return outs


segment_relax_cuda.launches = 0
