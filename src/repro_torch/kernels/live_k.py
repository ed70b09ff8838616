"""The live-k compaction that precedes each dense product on the card.

``live_k_cuda`` launches ``csrc/live_k.cu`` (design notes in the source)
on a CUDA frontier F = (fw, fx): for each of the product's split-K slices
it finds the columns k that some row keeps live, packs them from the
slice's first k and writes their k and counts (a :class:`LiveK`, all on
the card, no host sync). ``multpath_launch`` and ``centpath_launch`` call
it and hand the result to their kernel, which walks the live k alone. It
counts its launches in ``live_k_cuda.launches``. ``live_k_ref`` is its
plain PyTorch version.

``count_contraction`` records, while ``torch.profiler`` runs, each
product's contraction length (``products.k``) and its live count
(``products.k_live``, and ``products.k_live.<kernel>`` for the product's
own kind: the device scalar the compaction wrote, read at
``tracing.snapshot``).

``BK`` and ``slice_len`` define the products' split-K slices for the
wrappers too (``tropical_mm`` takes its k-tile from here).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch import tracing
from repro_torch.kernels import _build

_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 6
             + [ctypes.c_void_p])
BK = 16  # the products' contraction depth per stage: a slice is whole BKs
CH = 256  # columns a block of the compaction
K_COUNTER = "products.k"
K_LIVE_COUNTER = "products.k_live"


class LiveK(NamedTuple):
    """F's live columns, slice by slice: slice z's ``counts[z]`` live k
    are ``idx[z·L + i]`` (ascending) and ``w[:, z·L + i]``, ``x[:, z·L +
    i]`` their columns of F, with L = ``slice_len(n, S)``; ``counts[S]``
    is the total. Positions past a slice's count are not part of it."""

    w: torch.Tensor  # (nb, n) float32
    x: torch.Tensor  # (nb, n) float32
    idx: torch.Tensor  # (n,) int32
    counts: torch.Tensor  # (S + 1,) int32


def slice_len(n: int, splits: int) -> int:
    """The k range of each of the products' ``splits`` slices: ⌈⌈n/BK⌉/S⌉
    k-tiles of BK (the last slice the rest)."""
    return -(-(-(-n // BK)) // splits) * BK


def live_k_ref(fw: torch.Tensor, fx: torch.Tensor, splits: int,
               finite: bool) -> LiveK:
    """The plain version of ``live_k_cuda``. A column is live where some
    row's F.w is not what the product's guard turns into the identity
    candidate: +inf for multpath (``finite`` False), any non-finite value
    for centpath (True). Positions past a slice's count hold the identity
    (±inf, 0) and k = -1."""
    nb, n = fw.shape
    span = slice_len(n, splits)
    keep = torch.isfinite(fw) if finite else fw != float("inf")
    ks = torch.nonzero(keep.any(dim=0)).flatten()  # ascending
    z = ks // span
    per = torch.bincount(z, minlength=splits)[:splits]
    first = torch.cumsum(per, 0) - per
    pos = z * span + torch.arange(len(ks), device=fw.device) - first[z]
    w = torch.full_like(fw, -float("inf") if finite else float("inf"))
    x = torch.zeros_like(fx)
    idx = torch.full((n,), -1, dtype=torch.int32, device=fw.device)
    w[:, pos] = fw[:, ks]
    x[:, pos] = fx[:, ks]
    idx[pos] = ks.to(torch.int32)
    counts = torch.cat([per, per.sum().reshape(1)]).to(torch.int32)
    return LiveK(w, x, idx, counts)


def live_k_cuda(fw: torch.Tensor, fx: torch.Tensor, splits: int,
                finite: bool) -> LiveK:
    """F's live columns for a product of ``splits`` slices, on the card.
    ``fw``/``fx``: (nb, n) contiguous float32 CUDA tensors, nb >= 1 (the
    products' wrappers check them); ``finite`` selects centpath's
    liveness. Bitwise ``live_k_ref`` in ``counts``, and in ``idx``, ``w``
    and ``x`` at each slice's live positions. n = 0 launches nothing."""
    nb, n = fw.shape
    dev = fw.device
    span = slice_len(n, splits)
    chunks = -(-span // CH)
    w = torch.empty_like(fw)
    x = torch.empty_like(fx)
    if n == 0:
        return LiveK(w, x, torch.empty(0, dtype=torch.int32, device=dev),
                     torch.zeros(splits + 1, dtype=torch.int32, device=dev))
    counts = torch.empty(splits + 1, dtype=torch.int32, device=dev)
    # idx, then the chunks' counts, then a byte flag a column
    ints = torch.empty(n + splits * chunks + -(-n // 4), dtype=torch.int32,
                       device=dev)
    scratch = ints.data_ptr() + 4 * n
    fn = _build.function("live_k", _ARGTYPES)
    rc = fn(fw.data_ptr(), fx.data_ptr(), w.data_ptr(), x.data_ptr(),
            ints.data_ptr(), counts.data_ptr(), scratch,
            scratch + 4 * splits * chunks, nb, n, splits, span, int(finite),
            dev.index, torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"live_k launch failed: cudaError {rc}")
    live_k_cuda.launches += 1
    return LiveK(w, x, ints[:n], counts)


live_k_cuda.launches = 0


def count_contraction(kernel: str, n: int, counts: torch.Tensor) -> None:
    """While the profiler runs: one ``kernel`` product's contraction length
    ``n`` and its live count ``counts[-1]``, kept unread until the
    snapshot, in all and by the product's kind."""
    live = counts[-1]
    tracing.count(K_COUNTER, n)
    tracing.count(K_LIVE_COUNTER, live)
    tracing.count(f"{K_LIVE_COUNTER}.{kernel}", live)
