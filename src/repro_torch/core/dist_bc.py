"""Distributed MFBC batch step: Theorem 5.1 on a (pod, data, model) mesh.

A port of ``repro/core/dist_bc.py`` over ``torch.distributed``: every
rank runs the same program on its own shards (``launch.mesh.Mesh``), and
its local products are the Hopper kernels on the card (``kernels.ops``).

Mesh mapping (paper grid (p₁, p₂, p₃) = (√(p/c), √(p/c), c)):

* ``model`` ↔ p₁ — shards the adjacency's row (u) dimension and the
  state's vertex (v) dimension.
* ``data`` ↔ p₂ — shards the adjacency's column dimension and the state's
  source (s) dimension.
* ``pod`` ↔ p₃ = c — the replication factor: the adjacency is replicated
  across pods and each pod owns a disjoint slice of the source batch.

Per-relaxation collectives (per rank; F = frontier, C = product):

1. ``all_gather(F, data, dim=0)``            ≈ nnz(F)/p_model bytes
2. local generalized product (the kernels)   — no communication
3. monoid reduce over ``model``, then slice  ≈ nnz(C)/p_data  bytes
4. ``all_gather(C, data, dim=1)``            ≈ nnz(C)/p_model bytes

A monoid reduce is a MIN (MAX) ``all_reduce`` and a tie-masked SUM
(``spgemm.semiring``); a frontier's or product's fields ride one stacked
call. Each rank's state is (nb/(pod·data), n/model): its source rows and
its vertex columns; the adjacency block is (n/model, n/data), the same on
every pod. As in the reference, state columns are in the interleaved
order ``v(m; d', j) = d'·n/D + m·n/(D·M) + j`` and the adjacency's rows
are permuted on the host (``vertex_row_permutation``) to match.

Where the reference runs ``iters`` static iterations in each sweep (the
graph size by default), the port stops a sweep when its frontier is empty
on every rank: one whole-world MAX of a flag per iteration
(``Mesh.any_rank``), still bounded by ``iters``. Every rank therefore
runs the same collectives; the skipped iterations would change nothing.

Results (``run_sum``, ``run_moments``, ``run_segmented``) come back to
the host as float64 in the original vertex order, length n, identical on
every rank: the batch statistics are summed over the batch axes, then
gathered over model.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.mfbc import segment_fold
from repro_torch.core.monoids import INF, Centpath, Multpath, multpath_combine
from repro_torch.kernels import ops as kops
from repro_torch.kernels.tropical_mm import pick_splits, sm_count
from repro_torch.spgemm.dist import gather_tree, slice_tree
from repro_torch.spgemm.semiring import cp_reduce, mp_reduce


@dataclasses.dataclass(frozen=True)
class BCMeshConfig:
    """Static configuration of the distributed BC step."""

    n: int  # padded vertex count (divisible by data*model)
    nb: int  # global batch size (divisible by pod*data)
    iters_bf: int  # forward iteration bound (≥ weighted diameter)
    iters_br: int  # backward bound
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = "pod"  # None on single-pod meshes
    # The kernels' contraction split count on the card (None: each product
    # picks its own); fixed, a row's tie sums do not depend on its batch.
    splits: Optional[int] = None
    # Run every one of the ``iters`` iterations with no stop test (no
    # collective flag, no host read): the reference's static loop, which a
    # step traced without data (the dry run) needs.
    unroll: bool = False

    @property
    def batch_axes(self):
        return ((self.pod_axis, self.data_axis) if self.pod_axis
                else self.data_axis)


def _local_relax_mp(cfg, F: Multpath, a_loc) -> Multpath:
    return Multpath(*kops.multpath_matmul(F.w, F.m, a_loc, cfg.splits))


def _local_relax_cp(cfg, F: Centpath, at_loc) -> Centpath:
    return Centpath(*kops.centpath_matmul(F.w, F.p, at_loc, cfg.splits))


def _gather_rows(mesh, cfg, tree):
    """(nb_pod/data, x) -> (nb_pod, x): step 1, the frontier broadcast."""
    return gather_tree(tree, mesh, cfg.data_axis, 0)


def _reduce_scatter_gather(mesh, cfg, tree, reduce_fn):
    """Steps 3+4: ⊕-reduce over model and keep this rank's v slice, then
    re-gather v over data: (nb_pod, n/data) partial over model ->
    (nb_pod, n/model)."""
    red = slice_tree(reduce_fn(tree, mesh, cfg.model_axis), mesh,
                 cfg.model_axis, 1)  # (nb_pod, n/(data*model))
    return gather_tree(red, mesh, cfg.data_axis, 1)


def _slice_rows(mesh, cfg, tree):
    """Keep this rank's source rows: (nb_pod, x) -> (nb_pod/data, x)."""
    return slice_tree(tree, mesh, cfg.data_axis, 0)


def _dist_relax_mp(mesh, cfg, F: Multpath, a_loc) -> Multpath:
    """One distributed MFBF relaxation (steps 1–4)."""
    C_part = _local_relax_mp(cfg, _gather_rows(mesh, cfg, F), a_loc)
    C = _reduce_scatter_gather(mesh, cfg, C_part, mp_reduce)
    return _slice_rows(mesh, cfg, C)


def _dist_relax_cp(mesh, cfg, F: Centpath, at_loc) -> Centpath:
    """One distributed MFBr relaxation. The product reads F's w and p
    only, so ``F.c`` may be None and is then not gathered."""
    C_part = _local_relax_cp(cfg, _gather_rows(mesh, cfg, F), at_loc)
    C = _reduce_scatter_gather(mesh, cfg, C_part, cp_reduce)
    return _slice_rows(mesh, cfg, C)


def _count_children(mesh, cfg, Tw, at_loc):
    """Distributed SP-DAG child count, as a centpath relax over Aᵀ.

    c0(s, v) = #{u : Tw(s,v) + A(v,u) == Tw(s,u)}: contributions from u
    where Tw(s,u) - A(v,u) == Tw(s,v) land at v with count 1 each.
    Unreachable entries (+inf) are masked to the centpath identity (-inf)
    first — +inf would win the max-select.
    """
    w = torch.where(torch.isfinite(Tw), Tw, -INF)
    Pc = _dist_relax_cp(mesh, cfg, Centpath(w, torch.zeros_like(Tw), None),
                        at_loc)
    hit = (Pc.w == Tw) & torch.isfinite(Tw) & (Pc.c > 0)
    return torch.where(hit, Pc.c, 0.0).to(torch.int32)


def _local_ids(mesh, cfg):
    """Global vertex ids of this rank's state columns (interleaved order):
    column c on model index m is v = d'·(n/D) + m·(n/(D·M)) + j with
    d' = c // (n/(D·M)), j = c % (n/(D·M))."""
    n = cfg.n
    d_sz = mesh.size(cfg.data_axis)
    m_sz = mesh.size(cfg.model_axis)
    sub = n // (d_sz * m_sz)
    c = torch.arange(n // m_sz, device=mesh.device)
    return (c // sub) * (n // d_sz) + mesh.index(cfg.model_axis) * sub \
        + (c % sub)


def _seed_multpath(mesh, cfg, sources_loc):
    """Local seed frontier: (s, u) = (0, 1) iff u == source_s."""
    hit = sources_loc[:, None].long() == _local_ids(mesh, cfg)[None, :]
    return Multpath(torch.where(hit, 0.0, INF), hit.to(torch.float32))


def _batch_delta_local(mesh, cfg: BCMeshConfig, a_loc, at_loc, sources_loc,
                       valid_loc):
    """The full Algorithm 3 batch, this rank's view.

    Returns ``(contrib, mask, sweeps)`` with ``contrib[s, v] = δ_s(v)``
    for this rank's source rows and vertex columns (zeroed on unreachable
    and padding entries), ``mask[s, v] = [v reachable from s ∧ s valid]``
    and ``sweeps`` the counts (multpath relaxes, centpath relaxes, stop
    tests) that fix the batch's collective bytes.
    """
    n_mp, n_cp, n_stop = 1, 1, 0  # the seed relax and the child count
    # ---- MFBF ----
    T = _dist_relax_mp(mesh, cfg, _seed_multpath(mesh, cfg, sources_loc),
                       a_loc)  # direct edges (paper line 1)
    F = T
    for _ in range(cfg.iters_bf):
        n_stop += 1
        if not cfg.unroll and not mesh.any_rank(torch.isfinite(F.w)
                                                & (F.m > 0)):
            break
        n_mp += 1
        C = _dist_relax_mp(mesh, cfg, F, a_loc)
        T = multpath_combine(T, C)
        keep = (C.w == T.w) & torch.isfinite(C.w) & (C.m > 0)
        F = Multpath(torch.where(keep, C.w, INF), torch.where(keep, C.m, 0.0))

    # ---- mask the t = s destination ----
    ids = _local_ids(mesh, cfg)
    self_col = sources_loc[:, None].long() == ids[None, :]
    Tw = torch.where(self_col, INF, T.w)
    Tm_safe = torch.where(self_col | (T.m <= 0), 1.0, T.m)
    finite = torch.isfinite(Tw)

    # ---- MFBr ----
    c = _count_children(mesh, cfg, Tw, at_loc)
    Zp = torch.zeros_like(Tw)
    done = finite & (c == 0)
    newly = done

    def frontier(mask):
        return Centpath(torch.where(mask, Tw, -INF),
                        torch.where(mask, Zp + 1.0 / Tm_safe, 0.0), None)

    for _ in range(cfg.iters_br):
        n_stop += 1
        if not cfg.unroll and not mesh.any_rank(newly):
            break
        n_cp += 1
        Pc = _dist_relax_cp(mesh, cfg, frontier(newly), at_loc)
        contrib = (Pc.w == Tw) & finite & (Pc.c > 0)
        Zp = Zp + torch.where(contrib, Pc.p, 0.0)
        c = c - torch.where(contrib, Pc.c.to(c.dtype), 0)
        newly = finite & (c == 0) & ~done
        done = done | newly

    mask = finite & valid_loc[:, None]
    return torch.where(mask, Zp * T.m, 0.0), mask, (n_mp, n_cp, n_stop)


def local_shapes(mesh, cfg: BCMeshConfig) -> Dict[str, tuple]:
    """This rank's argument shapes of ``build_mfbc_step``'s step: its
    blocks of A and Aᵀ (n/model, n/data) and its source rows."""
    blk = (cfg.n // mesh.size(cfg.model_axis),
           cfg.n // mesh.size(cfg.data_axis))
    rows = (cfg.nb // mesh.size(cfg.batch_axes),)
    return {"a": blk, "at": blk, "sources": rows, "valid": rows}


def build_mfbc_step(mesh, cfg: BCMeshConfig):
    """The per-rank Theorem 5.1 batch step (the reference's
    ``build_mfbc_step``): ``step(a_loc, at_loc, sources_loc, valid_loc)``
    returns this rank's λ contribution, (n/model,) in the interleaved
    column order, summed over the batch axes. Every rank of ``mesh``
    calls it with its ``local_shapes`` blocks."""
    def step(a_loc, at_loc, sources_loc, valid_loc):
        contrib, _, _ = _batch_delta_local(mesh, cfg, a_loc, at_loc,
                                           sources_loc, valid_loc)
        return mesh.all_reduce(contrib.sum(dim=0), cfg.batch_axes,
                               dist.ReduceOp.SUM, kind="batch")

    return step


def model_mesh_bytes(n: int, nb: int, iters: int, axes: Dict[str, int],
                     word: int = 4) -> float:
    """§5.2 model: per-rank collective bytes of one batch step.

    A copy of ``benchmarks/comm_cost.py::model_mesh_bytes``. Each
    relaxation moves the pod-local dense state (nb/c rows × n vertices)
    three times — frontier gather, monoid reduce, product re-gather — at
    ``1/√(p/c)`` of its footprint per rank; one batch runs the forward and
    backward sweeps, ``iters`` relaxations each. The monoids' field counts
    and the second (tie-sum) reduce are not modeled: they are the constant
    factors between this model and ``Mesh.comm_bytes``.
    """
    p = 1
    for s in axes.values():
        p *= s
    c = axes.get("pod", 1)
    per_iter = 3.0 * word * (nb / c) * n / max(math.sqrt(p / c), 1.0)
    return per_iter * 2 * iters


def vertex_row_permutation(n: int, d_sz: int, m_sz: int) -> np.ndarray:
    """Π such that A[Π, :] cut into model row blocks has row blocks in the
    interleaved on-device vertex order (see the module docstring)."""
    sub = n // (d_sz * m_sz)
    perm = np.empty(n, dtype=np.int64)
    i = 0
    for m in range(m_sz):
        for d in range(d_sz):
            base = d * (n // d_sz) + m * sub
            perm[i:i + sub] = np.arange(base, base + sub)
            i += sub
    return perm


class MeshBCContext:
    """This rank's resident mesh state, shared across batch sizes.

    Pads the vertex count to a multiple of data·model, permutes the
    adjacency's rows, and uploads this rank's blocks of A and Aᵀ once,
    contiguous, on the mesh's device. ``g`` is a ``Graph`` (uploaded
    eagerly) or anything stats-like with an ``n`` and no edge arrays
    (``graphs.formats.GraphStats``): the context then has no adjacency
    until ``upload_coo_chunks`` / ``graphs.formats.
    build_sharded_adjacency`` streams one in, and the host never holds
    more than this rank's block.

    ``for_batches(n_b)`` fixes the kernels' split count for every batch
    of up to ``n_b`` sources (the executor calls it), so a row's results
    do not depend on the bucket its batch runs at.
    """

    def __init__(self, g, mesh, *, iters: int = 0):
        sizes = mesh.axis_sizes
        self.mesh = mesh
        self.n = g.n
        self._d_sz = sizes["data"]
        self._m_sz = sizes["model"]
        self._pod = "pod" if "pod" in sizes else None
        self._p_sz = sizes.get("pod", 1)
        self.chunk = self._p_sz * self._d_sz  # source-batch divisibility
        self.iters = iters if iters > 0 else g.n
        self.splits: Optional[int] = None
        lcm = self._d_sz * self._m_sz
        self.n_pad = -(-g.n // lcm) * lcm
        self.perm = vertex_row_permutation(self.n_pad, self._d_sz, self._m_sz)
        self._a = self._at = None
        self.sweeps = (0, 0, 0)  # the last batch's (mp, cp, stop) counts
        if hasattr(g, "src"):
            self.upload_graph(g)

    # -- adjacency upload ----------------------------------------------------
    def upload_graph(self, g) -> "MeshBCContext":
        """Upload a host-resident ``Graph``'s adjacency (one chunk)."""
        return self.upload_coo_chunks([(g.src, g.dst, g.w)])

    def upload_coo_chunks(self, chunks) -> "MeshBCContext":
        """Build this rank's blocks of A and Aᵀ from streamed COO chunks.

        Each ``(src, dst, w)`` chunk contributes the entries that land in
        this rank's row block (model index, permuted rows) and column
        block (data index); each block densifies on the host and goes to
        the device once. Duplicate arcs fold by ``min`` and self loops are
        dropped — bitwise ``coo_to_dense`` (+ inf diagonal) of the
        concatenated stream, for any chunking. Peak host memory is this
        rank's two blocks plus one chunk.
        """
        rb = self.n_pad // self._m_sz  # block rows  (model axis)
        cb = self.n_pad // self._d_sz  # block cols  (data axis)
        r0 = self.mesh.index("model") * rb
        c0 = self.mesh.index("data") * cb
        inv_perm = np.empty(self.n_pad, dtype=np.int64)
        inv_perm[self.perm] = np.arange(self.n_pad)
        blk_a = np.full((rb, cb), np.inf, dtype=np.float32)
        blk_at = np.full((rb, cb), np.inf, dtype=np.float32)
        for src, dst, w in chunks:
            src = np.asarray(src, dtype=np.int64)
            dst = np.asarray(dst, dtype=np.int64)
            w = np.asarray(w, dtype=np.float32)
            keep = src != dst  # A(i, i) = inf structurally
            src, dst, w = src[keep], dst[keep], w[keep]
            if src.shape[0] and int(max(src.max(), dst.max())) >= self.n:
                raise ValueError("vertex id out of range for this context")
            # A[perm, :]: arc (s, d) lands at row inv_perm[s], col d;
            # Aᵀ[perm, :]: at row inv_perm[d], col s.
            for blk, rows, cols in ((blk_a, inv_perm[src], dst),
                                    (blk_at, inv_perm[dst], src)):
                mine = ((rows >= r0) & (rows < r0 + rb) & (cols >= c0)
                        & (cols < c0 + cb))
                np.minimum.at(blk, (rows[mine] - r0, cols[mine] - c0),
                              w[mine])
        self._a = torch.from_numpy(blk_a).to(self.mesh.device)
        self._at = torch.from_numpy(blk_at).to(self.mesh.device)
        return self

    def _adjacency(self):
        if self._a is None:
            raise RuntimeError(
                "MeshBCContext has no adjacency resident: built from stats "
                "only — stream the graph in with upload_coo_chunks() / "
                "graphs.formats.build_sharded_adjacency() first")
        return self._a, self._at

    def round_nb(self, nb: int) -> int:
        """Smallest pod·data multiple ≥ nb (the mesh batch divisibility)."""
        return -(-nb // self.chunk) * self.chunk

    def for_batches(self, n_b: int) -> "MeshBCContext":
        """Fix the kernels' split count for batches of up to ``n_b``
        sources: the one ``pick_splits`` gives this rank's local product
        at ``round_nb(n_b)/pod`` rows (nothing on the CPU, whose plain
        products have no slices)."""
        if self.mesh.device.type == "cuda":
            rb, cb = self.n_pad // self._m_sz, self.n_pad // self._d_sz
            self.splits = pick_splits(self.round_nb(n_b) // self._p_sz, rb,
                                      cb, sm_count(self.mesh.device.index))
        return self

    def _cfg(self, nb_pad: int) -> BCMeshConfig:
        return BCMeshConfig(n=self.n_pad, nb=nb_pad, iters_bf=self.iters,
                            iters_br=self.iters, pod_axis=self._pod,
                            splits=self.splits)

    def _delta(self, nb: int, sources, valid):
        """This rank's (contrib, mask) and its rows' slice of the batch
        padded to ``round_nb(nb)``."""
        nb_pad = self.round_nb(nb)
        cfg = self._cfg(nb_pad)
        src = np.zeros(nb_pad, np.int32)
        val = np.zeros(nb_pad, bool)
        k = min(np.asarray(sources).shape[0], nb_pad)
        src[:k], val[:k] = np.asarray(sources)[:k], np.asarray(valid)[:k]
        rows = nb_pad // self.chunk
        lo = self.mesh.index(cfg.batch_axes) * rows
        dev = self.mesh.device
        a, at = self._adjacency()
        contrib, mask, self.sweeps = _batch_delta_local(
            self.mesh, cfg, a, at,
            torch.from_numpy(src[lo:lo + rows]).to(dev),
            torch.from_numpy(val[lo:lo + rows]).to(dev))
        return contrib, mask, cfg, slice(lo, lo + rows)

    def _finish(self, stats: torch.Tensor, cfg: BCMeshConfig) -> np.ndarray:
        """Sum this rank's per-vertex statistics over the batch axes,
        gather them over model, and undo the row permutation: float64 on
        the host, in the original vertex order, the same on every rank."""
        stats = self.mesh.all_reduce(stats, cfg.batch_axes,
                                     dist.ReduceOp.SUM, kind="batch")
        full = self.mesh.all_gather(stats, cfg.model_axis, stats.dim() - 1,
                                    kind="batch")
        out = np.zeros(full.shape, dtype=np.float64)
        out[..., self.perm] = full.cpu().numpy()
        return out[..., :self.n]

    def run_sum(self, sources, valid, *, nb: int) -> np.ndarray:
        """Σδ-only batch contribution, original vertex order, length n."""
        contrib, _, cfg, _ = self._delta(nb, sources, valid)
        return self._finish(contrib.sum(dim=0), cfg)

    def run_moments(self, sources, valid, *, nb: int):
        """(S1, S2, n_reach) per vertex — the sampling-epoch reduction.
        This rank's rows are folded in row order, as the single-host
        step folds a batch (``core.mfbc``)."""
        contrib, mask, cfg, _ = self._delta(nb, sources, valid)
        rows = np.zeros(contrib.shape[0], np.int64)
        stats = self._fold(contrib, mask, rows, 1)[0]
        s = self._finish(stats, cfg)
        return s[0], s[1], s[2].astype(np.int64)

    def run_segmented(self, sources, valid, slot_ids, n_slots: int, *,
                      nb: int):
        """Per-slot (S1, S2, n_reach), each (n_slots, n) — fused batches.
        Padding rows land in the dump segment ``n_slots``, dropped."""
        contrib, mask, cfg, mine = self._delta(nb, sources, valid)
        sid = np.full(self.round_nb(nb), n_slots, np.int64)
        k = min(np.asarray(slot_ids).shape[0], sid.shape[0])
        sid[:k] = np.asarray(slot_ids)[:k]
        s = self._finish(self._fold(contrib, mask, sid[mine], n_slots), cfg)
        return s[:, 0], s[:, 1], s[:, 2].astype(np.int64)

    @staticmethod
    def _fold(contrib, mask, slot_ids, n_slots: int) -> torch.Tensor:
        """(n_slots, 3, n/model): per-slot Σδ, Σδ², n_reach of this rank's
        rows, added in row order (``core.mfbc.segment_fold``)."""
        return segment_fold(torch.stack(
            [contrib, contrib * contrib, mask.to(contrib.dtype)], dim=1),
            slot_ids, n_slots)


def prepare_mesh_batch_step(g, mesh, *, nb: int, iters: int = 0,
                            moments: bool = False):
    """Single-``nb`` convenience wrapper over ``MeshBCContext``.

    Returns ``(run, nb_pad)``: ``run(sources, valid)`` takes host arrays
    of up to ``nb_pad`` sources and returns the batch's Σδ (float64, (n,))
    or, with ``moments=True``, ``(S1, S2, n_reach)``, in the original
    vertex order, the same on every rank.
    """
    ctx = MeshBCContext(g, mesh, iters=iters)
    nb_pad = ctx.round_nb(nb)
    ctx.for_batches(nb_pad)
    if moments:
        return (lambda s, v: ctx.run_moments(s, v, nb=nb_pad)), nb_pad
    return (lambda s, v: ctx.run_sum(s, v, nb=nb_pad)), nb_pad
