"""Multpath / centpath monoid algebra (paper Sections 3, 4.1.1, 4.2.1).

A *multpath* is a tuple ``(w, m)``: path weight + multiplicity. The monoid
``(M, ⊕)`` keeps the smaller weight and sums multiplicities on ties. The
Bellman-Ford *action* is ``f((w, m), a) = (w + a, m)``.

A *centpath* is a tuple ``(w, p, c)``: weight + partial centrality factor +
counter. The monoid ``(C, ⊗)`` keeps the **larger** weight and sums ``p``
and ``c`` on ties. The Brandes action is ``g((w, p, c), a) = (w - a, p, c)``.

Frontiers are dense in structure and sparse in value. A multpath entry is
*inactive* when ``(w, m) = (inf, 0)``; a centpath entry is inactive when
``w = -inf``. They are masked explicitly, because IEEE ``inf - a = inf``
would otherwise win the centpath max-selection.

The dense regime is a blocked generalized matmul against a dense ``(n, n)``
adjacency (``inf`` off-structure), ``C(i,j) = ⊕_k f(T(i,k), A(k,j))``, swept
over k-blocks in a Python loop so the ``(nb, bk, n)`` candidate block stays
bounded. It is the plain PyTorch version of the CUDA kernels in
``repro_torch.kernels`` and runs on any device. The COO and CSR regimes of
``repro.core.monoids`` are not ported yet.

Equality of float path weights is exact (paper assumes exact arithmetic;
integer-valued float32 weights are exact up to 2**24).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

INF = float("inf")


class Multpath(NamedTuple):
    w: torch.Tensor  # weights, inactive = +inf
    m: torch.Tensor  # multiplicities, inactive = 0


class Centpath(NamedTuple):
    w: torch.Tensor  # weights, inactive = -inf
    p: torch.Tensor  # partial centrality factor
    c: torch.Tensor  # counter (number of contributing children on ties)


def multpath_identity(shape, *, dtype=torch.float32, device=None) -> Multpath:
    return Multpath(torch.full(shape, INF, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))


def centpath_identity(shape, *, dtype=torch.float32, device=None) -> Centpath:
    return Centpath(torch.full(shape, -INF, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device),
                    torch.zeros(shape, dtype=dtype, device=device))


def multpath_combine(x: Multpath, y: Multpath) -> Multpath:
    """Elementwise ⊕: min weight, sum multiplicities on exact ties."""
    w = torch.minimum(x.w, y.w)
    tie = (x.w == y.w) & torch.isfinite(x.w)
    m = torch.where(x.w < y.w, x.m, torch.where(tie, x.m + y.m, y.m))
    return Multpath(w, m)


def centpath_combine(x: Centpath, y: Centpath) -> Centpath:
    """Elementwise ⊗: max weight, sum p and c on exact ties."""
    w = torch.maximum(x.w, y.w)
    tie = (x.w == y.w) & torch.isfinite(x.w)
    p = torch.where(x.w > y.w, x.p, torch.where(tie, x.p + y.p, y.p))
    c = torch.where(x.w > y.w, x.c, torch.where(tie, x.c + y.c, y.c))
    return Centpath(w, p, c)


def _mp_block(Fw, Fm, Ablk):
    """min-plus with multiplicities over one k-block.

    Fw, Fm: (nb, bk); Ablk: (bk, n) -> (nb, n) pair.
    """
    cand = Fw[:, :, None] + Ablk[None, :, :]  # (nb, bk, n); inf + x = inf
    w = cand.amin(dim=1)
    tie = (cand == w[:, None, :]) & torch.isfinite(cand)
    m = torch.where(tie, Fm[:, :, None], 0.0).sum(dim=1)
    return w, m


def multpath_relax_dense(F: Multpath, A: torch.Tensor, *,
                         block: int = 256) -> Multpath:
    """``C = F •_(⊕,f) A``: C(s,v) = ⊕_u f(F(s,u), A(u,v)).

    F.w/F.m: (nb, k); A: (k, n_out) with inf off-structure. Returns
    (nb, n_out), swept over ``block``-wide slices of the contraction dim.
    """
    nb, k = F.w.shape
    acc = multpath_identity((nb, A.shape[1]), dtype=F.w.dtype,
                            device=F.w.device)
    for k0 in range(0, k, block):
        w, m = _mp_block(F.w[:, k0:k0 + block], F.m[:, k0:k0 + block],
                         A[k0:k0 + block])
        acc = multpath_combine(acc, Multpath(w, m))
    return acc


def _cp_block(Fw, Fp, Bblk):
    """max-select with p/c tie sums over one k-block.

    Fw, Fp: (nb, bk); Bblk: (bk, n). Inactive F entries carry w = -inf.
    cand(s, v) = F.w(s, u) - B(u, v); inactive or no-edge -> -inf.
    """
    cand = Fw[:, :, None] - Bblk[None, :, :]
    cand = torch.where(torch.isfinite(Fw)[:, :, None]
                       & torch.isfinite(Bblk)[None, :, :], cand, -INF)
    w = cand.amax(dim=1)
    tie = (cand == w[:, None, :]) & torch.isfinite(cand)
    p = torch.where(tie, Fp[:, :, None], 0.0).sum(dim=1)
    c = tie.sum(dim=1, dtype=Fw.dtype)
    return w, p, c


def centpath_relax_dense(F: Centpath, B: torch.Tensor, *,
                         block: int = 256) -> Centpath:
    """``C = F •_(⊗,g) B`` with contraction over B's first axis.

    For the Brandes step the caller passes ``B = A.T`` so that
    ``C(s, v) = ⊗_u g(F(s, u), A(v, u))`` — contributions flow from
    SP-DAG children ``u`` back to predecessors ``v``.
    """
    nb, k = F.w.shape
    acc = centpath_identity((nb, B.shape[1]), dtype=F.w.dtype,
                            device=F.w.device)
    for k0 in range(0, k, block):
        w, p, c = _cp_block(F.w[:, k0:k0 + block], F.p[:, k0:k0 + block],
                            B[k0:k0 + block])
        acc = centpath_combine(acc, Centpath(w, p, c))
    return acc


def count_sp_children_dense(Tw: torch.Tensor, A: torch.Tensor, *,
                            block: int = 256) -> torch.Tensor:
    """c0(s, v) = #{u : T(s,v).w + A(v,u) == T(s,u).w, both finite}.

    The number of shortest-path-DAG children of v (vertices whose shortest
    path's last hop leaves v), as int32. Blocked over v's out-neighborhood.
    """
    nb, n = Tw.shape
    acc = torch.zeros((nb, n), dtype=torch.int32, device=Tw.device)
    for u0 in range(0, n, block):
        # cand(s, v, u) = Tw(s, v) + A(v, u)
        cand = Tw[:, :, None] + A[None, :, u0:u0 + block]
        hit = (cand == Tw[:, None, u0:u0 + block]) & torch.isfinite(cand)
        acc += hit.sum(dim=2, dtype=torch.int32)
    return acc
