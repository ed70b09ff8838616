"""The dense adjacency container of the main path.

``DenseAdj`` wraps an ``(n, n)`` float32 matrix with ``inf`` off-structure
and its transpose, built once at construction so the MFBr loop never
transposes. Its two relaxations go through ``repro_torch.kernels.ops``: on
the card that is always the Hopper kernels. ``CooAdj`` and ``CsrAdj`` of
``repro.core.adjacency`` are not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import monoids
from repro_torch.core.monoids import Centpath, Multpath
from repro_torch.graphs.formats import Graph, coo_to_dense
from repro_torch.kernels import ops as kops
from repro_torch.kernels.tropical_mm import pick_splits, sm_count


@dataclasses.dataclass
class DenseAdj:
    a: torch.Tensor  # (n, n) float32, inf off-structure
    # Transpose hoisted out of the relax loop: made contiguous once here.
    at: Optional[torch.Tensor] = None
    block: int = 512  # u-block of count_sp_children
    # Contraction split count of the kernels on the card; None lets each
    # product pick its own from its shape. Fixed, a row's tie sums do not
    # depend on how many rows share its batch (``for_batches``).
    splits: Optional[int] = None

    def __post_init__(self):
        if self.at is None:
            self.at = self.a.T.contiguous()

    @property
    def n(self) -> int:
        return self.a.shape[-1]

    def for_batches(self, n_b: int) -> "DenseAdj":
        """This adjacency with the split count fixed for every batch of up
        to ``n_b`` rows: the one ``pick_splits`` gives ``n_b`` rows on this
        card (nothing changes on the CPU, whose plain products have no
        slices). The executor serves several padded batch sizes and needs
        each row bitwise the same in all of them."""
        if not self.a.is_cuda:
            return self
        sms = sm_count(self.a.device.index)
        return dataclasses.replace(self,
                                   splits=pick_splits(n_b, self.n, self.n, sms))

    def gather_rows(self, sources: torch.Tensor) -> torch.Tensor:
        return self.a[sources.long()]

    def relax_mp(self, F: Multpath) -> Multpath:
        w, m = kops.multpath_matmul(F.w, F.m, self.a, self.splits)
        return Multpath(w, m)

    def relax_cp(self, F: Centpath) -> Centpath:
        w, p, c = kops.centpath_matmul(F.w, F.p, self.at, self.splits)
        return Centpath(w, p, c)

    def count_sp_children(self, Tw: torch.Tensor) -> torch.Tensor:
        return monoids.count_sp_children_dense(Tw, self.a, block=self.block)


def dense_adj_from_graph(g: Graph, *, block: int = 512,
                         device="cuda") -> DenseAdj:
    dev = resolve_device(device)
    return DenseAdj(torch.from_numpy(coo_to_dense(g)).to(dev), block=block)


def dense_adj_from_arrays(a: np.ndarray, at: Optional[np.ndarray] = None, *,
                          block: int = 512, device="cuda") -> DenseAdj:
    """A ``DenseAdj`` from host arrays, e.g. ``np.asarray(ref_adj.a)`` and
    ``np.asarray(ref_adj.at)`` of the reference container, so both packages
    relax the same matrix."""
    dev = resolve_device(device)

    def put(x):
        return torch.tensor(np.asarray(x, dtype=np.float32), device=dev)

    return DenseAdj(put(a), None if at is None else put(at), block)
