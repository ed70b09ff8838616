"""2D edge-partitioned GNN message passing — the paper's SpGEMM insight
applied to graph neural networks.

A port of ``repro/models/gnn_dist.py`` over the port's ``launch.mesh``.
Edges are assigned to an (R × C) grid of ranks, R = pod × data and
C = model, by (destination range, source shard):

* rank (r, c) holds the edges whose **source** lives in its local feature
  shard S_c and whose **destination** falls in contiguous range r, so the
  message gather is local;
* partial destination sums (N/R, h) reduce-scatter over ``model`` and
  all-gather over the destination-range axes: about |H|/R + |H|/C bytes a
  rank and layer, against 2·|H| for an all-reduce of a full partial
  buffer.

Node state lives in the interleaved Π-layout of the distributed BC step
(``core.dist_bc``); the closed-form id map lets the host bucket edges
once (``bucket_edges``, ``layout_features``: numpy, the reference's
arithmetic). Implemented for GCN.

The reference runs the layer inside ``shard_map``, where JAX transposes
each collective. Here each collective is a ``torch.autograd.Function``
whose backward is its adjoint: the reduce-scatter (an all-reduce, then
this rank's rows: gloo has no reliable ``reduce_scatter``) takes an
all-gather backward, the all-gather a reduce-scatter backward. The loss
sum over ``model`` is replicated over the R ranks of a column, and its
backward hands each rank's term the whole gradient, so each rank's
parameter gradient is R times its share; ``sync_grads`` sums the shares
over ``model`` and averages them over the destination-range axes, which
leaves the single-device gradient on every rank. The collectives count
their bytes in ``Mesh.comm_bytes`` under the mesh's kinds: the
reduce-scatters and the sums as ``tie_sum``, the all-gathers as
``gather``.

``abstract_inputs`` gives this rank's ``rank_inputs``, uninitialized
(fake under a ``FakeTensorMode``): the reference's sharded stand-ins as
the per-rank blocks the port's SPMD step takes.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.mesh import Mesh
from repro_torch.models.gnn import _gather, _seg_sum


@dataclasses.dataclass(frozen=True)
class Grid2D:
    n_pad: int  # padded node count (divisible by R*C)
    e_max: int  # max edges per device (padded)
    r_axes: Tuple[str, ...]  # destination-range axes (e.g. ("pod","data"))
    c_axis: str  # source-shard axis ("model")
    R: int
    C: int

    @property
    def sub(self) -> int:
        return self.n_pad // (self.R * self.C)

    @property
    def n_loc(self) -> int:  # state rows per device (model shard)
        return self.n_pad // self.C


def make_grid(mesh: Mesh, n: int, e_total: int) -> Grid2D:
    sizes = mesh.axis_sizes
    r_axes = tuple(a for a in ("pod", "data") if a in sizes)
    R = int(np.prod([sizes[a] for a in r_axes]))
    C = sizes["model"]
    n_pad = -(-n // (R * C)) * (R * C)
    # balanced-bucket assumption (paper §5.2 balls-into-bins): budget 1.5x
    e_max = -(-int(1.5 * e_total / (R * C)) // 128) * 128 + 128
    return Grid2D(n_pad, e_max, r_axes, "model", R, C)


# --- host-side bucketing ----------------------------------------------------


def _pos_in_layout(g: Grid2D, v: np.ndarray):
    """(shard c, local row) of vertex v in the interleaved Π-layout."""
    blk_r = g.n_pad // g.R
    c = (v % blk_r) // g.sub
    local = (v // blk_r) * g.sub + (v % g.sub)
    return c, local


def bucket_edges(g: Grid2D, src: np.ndarray, dst: np.ndarray,
                 coef: Optional[np.ndarray] = None):
    """Bucket edges onto the (R, C) grid.

    Returns (src_local, dst_local, coef): each (R*C, e_max). Bucket of
    edge (u, v): c = source's model shard, r = v // (N/R). dst_local
    indexes a per-device (N/R,) partial buffer; padding slots point at
    its dummy row N/R with coefficient 0. Raises when a bucket holds more
    than ``e_max`` edges.
    """
    if coef is None:
        coef = np.ones(src.shape[0], np.float32)
    blk_r = g.n_pad // g.R
    c_src, src_loc = _pos_in_layout(g, src.astype(np.int64))
    r_dst = dst.astype(np.int64) // blk_r
    dst_loc = dst.astype(np.int64) % blk_r
    bucket = r_dst * g.C + c_src

    nb = g.R * g.C
    order = np.argsort(bucket, kind="stable")
    bucket_s = bucket[order]
    counts = np.bincount(bucket_s, minlength=nb)
    if counts.max() > g.e_max:
        raise ValueError(f"bucket overflow: {counts.max()} > {g.e_max}")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    out_src = np.zeros((nb, g.e_max), np.int32)
    out_dst = np.full((nb, g.e_max), blk_r, np.int32)  # pad -> dummy row
    out_coef = np.zeros((nb, g.e_max), np.float32)
    for b in range(nb):
        sl = order[starts[b]:starts[b] + counts[b]]
        out_src[b, :counts[b]] = src_loc[sl]
        out_dst[b, :counts[b]] = dst_loc[sl]
        out_coef[b, :counts[b]] = coef[sl]
    return out_src, out_dst, out_coef


def layout_features(g: Grid2D, x: np.ndarray) -> np.ndarray:
    """Permute (N, d) host features into the Π-layout (concat of S_c)."""
    n, d = x.shape
    xp = np.zeros((g.n_pad, d), x.dtype)
    xp[:n] = x
    v = np.arange(g.n_pad)
    c, local = _pos_in_layout(g, v)
    out = np.zeros_like(xp)
    out[c * g.n_loc + local] = xp[v]
    return out


def rank_inputs(mesh: Mesh, g: Grid2D, x, src, dst, coef, labels, mask):
    """This rank's shard of the laid-out inputs (``layout_features``'
    rows, ``bucket_edges``' buckets), as tensors on the mesh's device:
    the rows of model shard c and the bucket (r, c), what the
    reference's ``shard_map`` hands device (r, c). ``labels`` and
    ``mask`` are (n_pad,) vectors."""
    c = mesh.index(g.c_axis)
    b = mesh.index(g.r_axes + (g.c_axis,))
    rows = slice(c * g.n_loc, (c + 1) * g.n_loc)

    def put(a, dtype=None):
        t = torch.from_numpy(np.array(a))
        return t.to(device=mesh.device, dtype=dtype or t.dtype)

    return (put(x[rows]), put(src[b], torch.long), put(dst[b], torch.long),
            put(coef[b]), put(labels[rows], torch.long),
            put(mask[rows], torch.bool))


def abstract_inputs(mesh: Mesh, g: Grid2D, d_in: int):
    """This rank's ``rank_inputs`` uninitialized, by name: x (n_loc, d_in);
    src/dst int64 and coef f32 (e_max,), its bucket; labels int64 and
    mask bool (n_loc,)."""
    dev = mesh.device
    e = (g.e_max,)
    return {"x": torch.empty((g.n_loc, d_in), device=dev),
            "src": torch.empty(e, dtype=torch.long, device=dev),
            "dst": torch.empty(e, dtype=torch.long, device=dev),
            "coef": torch.empty(e, device=dev),
            "labels": torch.empty((g.n_loc,), dtype=torch.long, device=dev),
            "mask": torch.empty((g.n_loc,), dtype=torch.bool, device=dev)}


# --- device-side 2D GCN -----------------------------------------------------


class _ReduceScatter(torch.autograd.Function):
    """The sum over ``axis`` of each rank's (rows, h) block, this rank's
    ``rows / size`` of it (an all-reduce, then a slice); its adjoint is
    the all-gather of the gradient's blocks."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        ctx.mesh, ctx.axis = mesh, axis
        k, i = mesh.size(axis), mesh.index(axis)
        rows = x.shape[0] // k
        out = mesh.all_reduce(x.clone(), axis, dist.ReduceOp.SUM,
                              kind="tie_sum")
        return out[i * rows:(i + 1) * rows].clone()

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.all_gather(grad, ctx.axis, dim=0), None, None


class _AllGather(torch.autograd.Function):
    """The blocks of every rank along ``axes``, concatenated on dim 0; its
    adjoint is the reduce-scatter of the gradient (every rank's gradient
    of this rank's block, summed)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axes: Tuple[str, ...]):
        ctx.mesh, ctx.axes = mesh, axes
        return mesh.all_gather(x, axes, dim=0)

    @staticmethod
    def backward(ctx, grad):
        mesh, axes = ctx.mesh, ctx.axes
        rows = grad.shape[0] // mesh.size(axes)
        i = mesh.index(axes)
        total = mesh.all_reduce(grad.clone(), axes, dist.ReduceOp.SUM,
                                kind="tie_sum")
        return total[i * rows:(i + 1) * rows].clone(), None, None


class _Sum(torch.autograd.Function):
    """The sum over ``axis`` of a scalar; its backward hands this rank's
    term the whole gradient (``sync_grads`` averages the copies)."""

    @staticmethod
    def forward(ctx, x, mesh: Mesh, axis: str):
        return mesh.all_reduce(x.clone(), axis, dist.ReduceOp.SUM,
                               kind="tie_sum")

    @staticmethod
    def backward(ctx, grad):
        return grad, None, None


def _gcn2d_local(mesh: Mesh, g: Grid2D, n_layers: int, params, x_loc, src,
                 dst, coef, labels_loc, mask_loc) -> torch.Tensor:
    """Per-rank GCN forward + CE loss. x_loc: (n_loc, d)."""
    blk_r = g.n_pad // g.R

    def propagate(h):  # h: (n_loc, dh) -> aggregated (n_loc, dh)
        m = _gather(h, src) * coef[:, None]  # local gather (E, dh)
        part = _seg_sum(m, dst, blk_r + 1)[:blk_r]
        # reduce over model (partial over src shards), scatter rows
        part = _ReduceScatter.apply(part, mesh, g.c_axis)  # (blk_r/C, dh)
        # re-gather rows over the dst-range axes -> (n_loc, dh), Π-layout
        return _AllGather.apply(part, mesh, g.r_axes)

    h = x_loc
    for i, w in enumerate(params["w"]):
        h = propagate(h @ w)
        if i + 1 < n_layers:
            h = F.relu(h)
    # masked CE over local rows; every row appears once per (model) fiber
    logz = torch.logsumexp(h, dim=-1)
    gold = torch.gather(h, 1, labels_loc[:, None])[:, 0]
    loss = torch.sum(torch.where(mask_loc, logz - gold, 0.0))
    cnt = torch.sum(mask_loc.to(h.dtype))
    loss = _Sum.apply(loss, mesh, g.c_axis)
    cnt = mesh.all_reduce(cnt, g.c_axis, dist.ReduceOp.SUM, kind="tie_sum")
    return loss / torch.clamp(cnt, min=1.0)


def build_gcn2d_loss(mesh: Mesh, g: Grid2D, n_layers: int):
    """Returns the per-rank ``loss(params, x_loc, src, dst, coef, labels,
    mask)`` on the 2D grid (``rank_inputs`` gives the rank's arguments;
    ``params`` is replicated: every rank holds the same tree). Every rank
    returns the whole loss; after ``torch.autograd.grad`` of it,
    ``sync_grads`` makes the parameter gradients the single-device ones.
    Every rank of the mesh must call it, in the same order."""

    def loss(params, x_loc, src, dst, coef, labels, mask):
        return _gcn2d_local(mesh, g, n_layers, params, x_loc, src, dst,
                            coef, labels, mask)

    return loss


def sync_grads(mesh: Mesh, g: Grid2D, grads):
    """The parameter gradients of ``build_gcn2d_loss``'s loss, summed
    over ``model`` and averaged over the destination-range axes (each
    rank's holds R times its share: see the module docstring), in
    place; returns the list of leaves."""
    out = []
    for leaf in grads:
        t = mesh.all_reduce(leaf, g.c_axis, dist.ReduceOp.SUM,
                            kind="tie_sum")
        t = mesh.all_reduce(t, g.r_axes, dist.ReduceOp.SUM, kind="tie_sum")
        out.append(t.div_(g.R))
    return out
