"""Generalized (⊕, f) matmul semantics for the distributed SpGEMM layer.

A port of ``repro/spgemm/semiring.py``. The paper replaces semirings with
a commutative monoid ``(D_C, ⊕)`` plus a map ``f : D_A × D_B → D_C``
(Section 3). A ``GeneralizedSemiring`` packages what the distributed
programs need:

* ``block_mm(a, b)`` — the local generalized product on blocks (a tuple of
  fields for the monoids), through ``repro_torch.kernels.ops``: the Hopper
  kernels for CUDA tensors, their plain versions for CPU ones;
* ``combine(x, y)`` — elementwise ⊕;
* ``axis_reduce(x, mesh, axis)`` — the ⊕-reduction over a mesh axis.

A monoid reduction is two ``all_reduce`` calls: a MIN (MAX for centpath)
to agree on the winning weight, then a SUM of the tie-masked payloads
(``m``; ``p`` and ``c`` stacked into one call for centpath), with the tie
mask ``(w == wext) & isfinite(wext)``. Each goes through the mesh's
wrappers, which count its bytes (``launch.mesh``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Tuple

import torch
import torch.distributed as dist

from repro_torch.core.monoids import (Centpath, Multpath, centpath_combine,
                                      centpath_identity, multpath_combine,
                                      multpath_identity)
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class GeneralizedSemiring:
    name: str
    block_mm: Callable[[Any, torch.Tensor], Any]
    combine: Callable[[Any, Any], Any]
    axis_reduce: Callable[[Any, Any, str], Any]  # (x, mesh, axis)
    identity: Callable[..., Any]  # (shape, *, device)
    # bytes per element of each operand domain (for the cost model)
    elem_bytes: Tuple[int, int, int] = (4, 4, 4)


# --- standard arithmetic (+, ×) ----------------------------------------------

def _arith_reduce(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    return mesh.all_reduce(x.clone(), axis, dist.ReduceOp.SUM,
                           kind="tie_sum")


arithmetic = GeneralizedSemiring(
    name="arith",
    block_mm=lambda a, b: a @ b,
    combine=lambda x, y: x + y,
    axis_reduce=_arith_reduce,
    identity=lambda shape, *, device=None: torch.zeros(shape, device=device),
)


# --- multpath (MFBF action): A = Multpath frontier, B = adjacency --------------

def _mp_mm(a: Multpath, b: torch.Tensor) -> Multpath:
    return Multpath(*kops.multpath_matmul(a.w, a.m, b))


def mp_reduce(x: Multpath, mesh, axis: str) -> Multpath:
    wmin = mesh.all_reduce(x.w.clone(), axis, dist.ReduceOp.MIN,
                           kind="extremum")
    tie = (x.w == wmin) & torch.isfinite(wmin)
    m = mesh.all_reduce(torch.where(tie, x.m, 0.0), axis,
                        dist.ReduceOp.SUM, kind="tie_sum")
    return Multpath(wmin, m)


multpath = GeneralizedSemiring(
    name="multpath",
    block_mm=_mp_mm,
    combine=multpath_combine,
    axis_reduce=mp_reduce,
    identity=lambda shape, *, device=None: multpath_identity(shape,
                                                             device=device),
    elem_bytes=(8, 4, 8),
)


# --- centpath (MFBr action) ----------------------------------------------------

def _cp_mm(a: Centpath, b: torch.Tensor) -> Centpath:
    return Centpath(*kops.centpath_matmul(a.w, a.p, b))


def cp_reduce(x: Centpath, mesh, axis: str) -> Centpath:
    wmax = mesh.all_reduce(x.w.clone(), axis, dist.ReduceOp.MAX,
                           kind="extremum")
    tie = (x.w == wmax) & torch.isfinite(wmax)
    pc = mesh.all_reduce(torch.stack([torch.where(tie, x.p, 0.0),
                                      torch.where(tie, x.c, 0.0)]),
                         axis, dist.ReduceOp.SUM, kind="tie_sum")
    return Centpath(wmax, pc[0], pc[1])


centpath = GeneralizedSemiring(
    name="centpath",
    block_mm=_cp_mm,
    combine=centpath_combine,
    axis_reduce=cp_reduce,
    identity=lambda shape, *, device=None: centpath_identity(shape,
                                                             device=device),
    elem_bytes=(12, 4, 12),
)


def by_name(name: str) -> GeneralizedSemiring:
    return {"arith": arithmetic, "multpath": multpath,
            "centpath": centpath}[name]
