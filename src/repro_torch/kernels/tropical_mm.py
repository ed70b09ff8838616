"""Wrapper for the Hopper multpath kernel (the MFBF Bellman-Ford action).

``multpath_matmul_cuda`` launches ``csrc/multpath_mm.cu`` (design notes in
the source) on CUDA tensors and nothing else: it checks device, dtype,
shape and contiguity, allocates the outputs and the split-K scratch, picks
the split count, packs the frontier's live columns (``live_k``), launches
on the current stream, raises if the launch fails, and counts its launches
in ``multpath_matmul_cuda.launches``. Its plain PyTorch version is
``repro_torch.kernels.ref.multpath_matmul_ref``. ``pick_splits``,
``resolve_splits`` and ``check_operands`` serve both kernels.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import _build, live_k
from repro_torch.kernels.live_k import BK

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
             + [ctypes.c_void_p])
# The tile of both kernels (BM x BN outputs, BK deep per stage, 8 warps).
BM, BN = 64, 64
WARPS_PER_BLOCK = 8
MAX_ROWS = 65535 * BM  # grid.y limit times the row tile
MIN_SLICE_K_TILES = 4  # each slice sweeps at least 4·BK of k


def _even_splits(splits: int, k_tiles: int) -> int:
    """``splits`` cut down so that no slice of ``k_tiles`` is empty: the
    kernels give every slice ⌈k_tiles/S⌉ tiles and the last the rest."""
    if k_tiles == 0:
        return 1
    return -(-k_tiles // -(-k_tiles // splits))


def pick_splits(nb: int, n: int, n2: int, sms: int) -> int:
    """Number S of contraction slices (grid.z) for one (nb, n) x (n, n2)
    product on a card with ``sms`` SMs.

    The fewest slices whose ``S·tiles`` blocks give each SM at least two
    blocks (16 warps) and spread in whole blocks over the SMs with the
    busiest SM at most 1/0.9 of the mean (or at least 8 blocks per SM,
    where the last round matters little). No slice is shorter than
    ``MIN_SLICE_K_TILES`` k-tiles, and none is empty. (On the H100 the
    blocks run two per SM; ``tools/torch_split_sweep.py`` times the
    kernels over S.)
    """
    tiles = -(-nb // BM) * -(-n2 // BN)
    k_tiles = -(-n // BK)
    s_max = max(1, k_tiles // MIN_SLICE_K_TILES)
    for s in range(1, s_max + 1):
        s = _even_splits(s, k_tiles)
        per_sm = tiles * s / sms
        if per_sm >= 2 and (per_sm >= 8
                            or per_sm / math.ceil(per_sm) >= 0.9):
            return s
    return _even_splits(s_max, k_tiles)


@functools.lru_cache(maxsize=None)
def sm_count(device_index: int) -> int:
    return torch.cuda.get_device_properties(device_index).multi_processor_count


def scratch_ptr(fw: torch.Tensor, n2: int, fields: int, splits: int):
    """(buffer, pointer) of the slices' partials: for S > 1 a
    ``(fields, S, nb, n2)`` float32 buffer, for S = 1 none (None, None).
    The caller holds the buffer until the launch is queued; after that the
    caching allocator reuses it only in stream order."""
    if splits == 1:
        return None, None
    part = torch.empty((fields, splits, fw.shape[0], n2),
                       dtype=torch.float32, device=fw.device)
    return part, part.data_ptr()


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


def multpath_launch(fw: torch.Tensor, fm: torch.Tensor, a: torch.Tensor,
                    splits: int):
    """Pack F's live columns and launch ``csrc/multpath_mm.cu`` over them
    with ``splits`` contraction slices, on operands that ``check_operands``
    passed, nb and n2 > 0. Counts no launch (``multpath_matmul_cuda``
    is the entry point); records the contraction's k and live k while the
    profiler runs (``live_k.count_contraction``)."""
    nb, n = fw.shape
    n2 = a.shape[1]
    f = live_k.live_k_cuda(fw, fm, splits, finite=False)
    cw = torch.empty((nb, n2), dtype=torch.float32, device=fw.device)
    cm = torch.empty((nb, n2), dtype=torch.float32, device=fw.device)
    part, part_ptr = scratch_ptr(fw, n2, 2, splits)
    fn = _build.function("multpath_mm", _ARGTYPES)
    rc = fn(f.w.data_ptr(), f.x.data_ptr(), a.data_ptr(), f.idx.data_ptr(),
            f.counts.data_ptr(), cw.data_ptr(), cm.data_ptr(), part_ptr, nb,
            n, n2, splits, fw.device.index,
            torch.cuda.current_stream(fw.device).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"multpath_mm launch failed: cudaError {rc}")
    live_k.count_contraction("multpath_mm", n, f.counts)
    return cw, cm


def resolve_splits(splits, nb: int, n: int, n2: int, device) -> int:
    """The split count to launch with: ``pick_splits`` for this shape and
    card when ``splits`` is None, else ``splits`` itself, which must cut
    the contraction into non-empty slices. A caller that fixes S for
    every batch size (``repro_torch.bc.executor``) gets rows whose tie
    sums do not depend on the batch they run in."""
    if splits is None:
        return pick_splits(nb, n, n2, sm_count(device.index))
    k_tiles = -(-n // BK)
    if splits < 1 or _even_splits(splits, k_tiles) != splits:
        raise ValueError(f"splits={splits} leaves an empty slice of the "
                         f"{k_tiles} k-tiles of n={n}")
    return int(splits)


def multpath_matmul_cuda(fw: torch.Tensor, fm: torch.Tensor, a: torch.Tensor,
                         splits=None):
    """fw/fm: (nb, n); a: (n, n2), float32 on one CUDA device.

    Returns (cw, cm): (nb, n2) with ``cw = min_k fw[:, k] + a[k]`` and
    ``cm`` the tie-summed multiplicities. The contraction is split into
    ``splits`` slices, by default ``pick_splits``' choice for this card.
    """
    check_operands((fw, fm), a, "multpath_matmul_cuda")
    nb, n = fw.shape
    n2 = a.shape[1]
    if nb == 0 or n2 == 0:
        return (torch.empty((nb, n2), dtype=torch.float32, device=fw.device),
                torch.empty((nb, n2), dtype=torch.float32, device=fw.device))
    out = multpath_launch(fw, fm, a,
                          resolve_splits(splits, nb, n, n2, fw.device))
    multpath_matmul_cuda.launches += 1
    return out


multpath_matmul_cuda.launches = 0
