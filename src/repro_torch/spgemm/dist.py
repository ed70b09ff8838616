"""Distributed SpGEMM variants as per-rank programs (paper §5.2).

A port of ``repro/spgemm/dist.py`` over ``torch.distributed``: where the
reference writes each variant as a ``shard_map`` program, here every rank
runs the same local program on its own shards and the collectives go
through the ``launch.mesh.Mesh`` wrappers. ``spgemm(a_loc, b_loc, mesh,
plan, sr)`` takes this rank's blocks of ``L: (m, k)`` and ``R: (k, n)`` in
the layouts ``plan_specs`` names and returns its block of the generalized
product ``C(i,j) = ⊕_k f(L(i,k), R(k,j))``; ``local_block`` cuts a rank's
block out of a global tensor.

Variants (L/R = left/right operand):

* ``1d_a`` — gather L; R and C column-sharded.
* ``1d_b`` — gather R; L and C row-sharded.
* ``1d_c`` — shard the contraction; ⊕-reduce C.
* ``2d_ab`` — SUMMA: gather L along grid columns and R along grid rows.
* ``2d_ac`` — gather L, ⊕-reduce then slice C (R stationary).
* ``2d_bc`` — gather R, ⊕-reduce then slice C (L stationary).
* ``3d_l_*``, ``3d_r_*``, ``3d_c_*`` — L replicated, R replicated, or the
  contraction split over the first axis, around any 2D variant on the
  other two (the Theorem 5.1 BC step is ``3d_r_ac``).

A spec is a tuple with one entry per dimension: ``None`` (replicated), an
axis name, or a tuple of axis names (the first the most significant), as
a ``PartitionSpec`` is in the reference. Every reduce-and-slice reduces in
full and then keeps this rank's slice, also for ``arith``, so that every
semiring moves the same bytes.
"""
from __future__ import annotations

from typing import Any, Tuple, Union

import torch

from repro_torch.spgemm.autotune import Plan
from repro_torch.spgemm.semiring import GeneralizedSemiring, arithmetic

Tree = Any  # a tensor, or a Multpath / Centpath of tensors (None skipped)
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def tree_map(fn, x: Tree) -> Tree:
    if isinstance(x, torch.Tensor):
        return fn(x)
    return type(x)(*(None if v is None else fn(v) for v in x))


def gather_tree(x: Tree, mesh, axis: str, dim: int) -> Tree:
    """All-gather every field of ``x`` over ``axis`` along ``dim``: the
    fields are stacked into one call."""
    if isinstance(x, torch.Tensor):
        return mesh.all_gather(x, axis, dim)
    fields = [v for v in x if v is not None]
    out = iter(mesh.all_gather(torch.stack(fields), axis, dim + 1
                               ).unbind(0))
    return type(x)(*(None if v is None else next(out) for v in x))


def slice_tree(x: Tree, mesh, axis: str, dim: int) -> Tree:
    """This rank's ``1/size(axis)`` slice of ``dim``."""
    idx, sz = mesh.index(axis), mesh.size(axis)

    def slc(v):
        blk = v.shape[dim] // sz
        return v.narrow(dim, idx * blk, blk).contiguous()

    return tree_map(slc, x)


def _reduce_slice(x: Tree, mesh, axis: str, dim: int,
                  sr: GeneralizedSemiring) -> Tree:
    """⊕-reduce over an axis, then keep this rank's slice of ``dim``."""
    return slice_tree(sr.axis_reduce(x, mesh, axis), mesh, axis, dim)


# --------------------------------------------------------------------------
# Layout tables: input/output specs per variant.
# --------------------------------------------------------------------------


def plan_specs(plan: Plan) -> Tuple[Spec, Spec, Spec]:
    """(spec_L, spec_R, spec_C) for the global operands under ``plan``."""
    v, ax = plan.variant, plan.axes
    if v == "1d_a":
        (q,) = ax
        return (None, q), (None, q), (None, q)
    if v == "1d_b":
        (q,) = ax
        return (q, None), (q, None), (q, None)
    if v == "1d_c":
        (q,) = ax
        return (None, q), (q, None), (None, None)
    if v == "2d_ab":
        r, c = ax
        return (r, c), (r, c), (r, c)
    if v == "2d_ac":
        r, c = ax
        return (c, r), (r, c), (r, c)
    if v == "2d_bc":
        r, c = ax
        return (r, c), (c, r), (r, c)
    if v.startswith("3d_"):
        _, x, yz = v.split("_")
        sL, sR, sC = plan_specs(Plan(f"2d_{yz}", ax[1:]))
        p1 = ax[0]

        def stack(spec: Spec, dim: int) -> Spec:
            parts = list(spec)
            cur = parts[dim]
            parts[dim] = (p1,) + ((cur,) if isinstance(cur, str)
                                  else tuple(cur or ()))
            return tuple(parts)

        if x == "l":  # L replicated over p1; R, C split their free dim (n)
            return sL, stack(sR, 1), stack(sC, 1)
        if x == "r":  # R replicated over p1; L, C split their free dim (m)
            return stack(sL, 0), sR, stack(sC, 0)
        if x == "c":  # contraction split over p1
            return stack(sL, 1), stack(sR, 0), sC
    raise ValueError(f"unknown variant {plan.variant}")


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def local_block(x: Tree, spec: Spec, mesh) -> Tree:
    """This rank's block of the global ``x`` laid out as ``spec``
    (contiguous, on the mesh's device)."""

    def cut(v):
        for dim, entry in enumerate(spec):
            axes = _entry_axes(entry)
            if axes:
                blk = v.shape[dim] // mesh.size(axes)
                v = v.narrow(dim, mesh.index(axes) * blk, blk)
        return v.contiguous().to(mesh.device)

    return tree_map(cut, x)


# --------------------------------------------------------------------------
# Local (per-rank) programs.
# --------------------------------------------------------------------------


def _local_1d_a(plan, mesh, sr, a, b):
    (q,) = plan.axes
    return sr.block_mm(gather_tree(a, mesh, q, 1), b)  # bytes ≈ nnz(L)


def _local_1d_b(plan, mesh, sr, a, b):
    (q,) = plan.axes
    return sr.block_mm(a, gather_tree(b, mesh, q, 0))  # bytes ≈ nnz(R)


def _local_1d_c(plan, mesh, sr, a, b):
    (q,) = plan.axes
    return sr.axis_reduce(sr.block_mm(a, b), mesh, q)  # bytes ≈ nnz(C)


def _local_2d_ab(plan, mesh, sr, a, b):
    r, c = plan.axes
    a_row = gather_tree(a, mesh, c, 1)  # bytes ≈ nnz(L)/p_r
    b_col = gather_tree(b, mesh, r, 0)  # bytes ≈ nnz(R)/p_c
    return sr.block_mm(a_row, b_col)


def _local_2d_ac(plan, mesh, sr, a, b):
    r, c = plan.axes
    a_full = gather_tree(a, mesh, c, 0)  # L arrives (m, k/p_r)
    c_part = sr.block_mm(a_full, b)  # (m, n/p_c), partial over r
    return _reduce_slice(c_part, mesh, r, 0, sr)  # bytes ≈ nnz(C)/p_c


def _local_2d_bc(plan, mesh, sr, a, b):
    r, c = plan.axes
    b_full = gather_tree(b, mesh, r, 1)  # R arrives (k/p_c, n)
    c_part = sr.block_mm(a, b_full)  # (m/p_r, n), partial over c
    return _reduce_slice(c_part, mesh, c, 1, sr)  # bytes ≈ nnz(C)/p_r


_LOCAL = {
    "1d_a": _local_1d_a,
    "1d_b": _local_1d_b,
    "1d_c": _local_1d_c,
    "2d_ab": _local_2d_ab,
    "2d_ac": _local_2d_ac,
    "2d_bc": _local_2d_bc,
}


def _local_3d(plan, mesh, sr, a, b):
    _, x, yz = plan.variant.split("_")
    inner = Plan(f"2d_{yz}", plan.axes[1:])
    c_part = _LOCAL[inner.variant](inner, mesh, sr, a, b)
    if x in ("l", "r"):
        # The replicated operand is identical across p1 (its spec omits
        # p1): the inner 2D product runs independently per p1 slice.
        return c_part
    # x == "c": the contraction is split over p1, the product partial.
    return sr.axis_reduce(c_part, mesh, plan.axes[0])


def spgemm(a_loc: Tree, b_loc: Tree, mesh, plan: Plan,
           sr: GeneralizedSemiring = arithmetic) -> Tree:
    """This rank's block of the distributed generalized product, from its
    blocks of L and R in ``plan_specs(plan)``'s layouts. Every rank of
    the mesh calls it with the same plan and semiring."""
    local = (_local_3d if plan.variant.startswith("3d_")
             else _LOCAL.get(plan.variant))
    if local is None:
        raise ValueError(f"unknown variant {plan.variant}")
    return local(plan, mesh, sr, a_loc, b_loc)
