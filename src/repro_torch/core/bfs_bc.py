"""BFS-based batched betweenness centrality (the "CombBLAS-like" baseline).

A port of ``repro/core/bfs_bc.py``. Unweighted graphs only. This is the
matrix-algebraic Brandes formulation the paper compares against (Section
7): forward BFS waves accumulate σ and depth; the backward sweep walks
depth levels from the deepest frontier to the root. Unlike MFBC, (a) it
cannot handle weights and (b) each vertex appears in exactly one frontier,
so the frontier schedule is the BFS level structure rather than the
maximal frontier.

It relaxes through the same adjacency containers as MFBC (on the card the
dense products or the sparse-relax kernel), so a comparison isolates the
algorithmic difference. Both sweeps run a fixed ``max_depth`` levels, as
the reference's ``fori_loop`` does: levels past the graph's depth are
empty and change nothing.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.adjacency import coo_adj_from_graph, dense_adj_from_graph
from repro_torch.core.monoids import INF, Centpath, Multpath
from repro_torch.graphs.formats import Graph


def _bfs_forward(adj, sources: torch.Tensor, max_depth: int):
    """Returns depth (nb, n) float32 (inf unreached) and sigma (nb, n)."""
    nb = sources.shape[0]
    rows = torch.arange(nb, device=sources.device)
    src = sources.long()
    depth = torch.full((nb, adj.n), INF, device=sources.device)
    depth[rows, src] = 0.0
    sigma = torch.zeros((nb, adj.n), device=sources.device)
    sigma[rows, src] = 1.0
    f_sigma = sigma
    for lev in range(max_depth):
        # propagate path counts one hop: contributions of the current level
        C = adj.relax_mp(Multpath(torch.where(f_sigma > 0, depth, INF),
                                  f_sigma))
        # newly reached vertices at this level
        new = (C.m > 0) & ~torch.isfinite(depth)
        depth = torch.where(new, lev + 1.0, depth)
        sigma = sigma + torch.where(new, C.m, 0.0)
        f_sigma = torch.where(new, C.m, 0.0)
    return depth, sigma


def _backward(adj, depth: torch.Tensor, sigma: torch.Tensor,
              max_depth: int) -> torch.Tensor:
    """δ accumulation level by level (classic algebraic Brandes)."""
    sigma_safe = torch.where(sigma > 0, sigma, 1.0)
    delta = torch.zeros_like(sigma)
    for lev in range(max_depth, 0, -1):  # levels max_depth .. 1
        # frontier: vertices at depth == lev carrying (1 + δ)/σ; the
        # others are off-level (w = -inf)
        at = depth == lev
        fp = torch.where(at, (1.0 + delta) / sigma_safe, 0.0)
        P = adj.relax_cp(Centpath(torch.where(at, depth, -INF), fp,
                                  at.to(depth.dtype)))
        # predecessors are exactly one level up
        take = (P.w == depth) & (depth == lev - 1.0) & (P.c > 0)
        delta = delta + torch.where(take, P.p * sigma, 0.0)
    return delta


def bfs_bc_batch(adj, sources: torch.Tensor, valid: torch.Tensor, *,
                 max_depth: int) -> torch.Tensor:
    """One batch of the baseline: (n,) λ_partial over the valid sources."""
    depth, sigma = _bfs_forward(adj, sources, max_depth)
    rows = torch.arange(sources.shape[0], device=sources.device)
    # exclude t = s and v = s as in MFBC
    depth[rows, sources.long()] = INF
    delta = _backward(adj, depth, sigma, max_depth)
    contrib = torch.where(torch.isfinite(depth) & valid[:, None], delta, 0.0)
    return contrib.sum(dim=0)


def bfs_bc(g: Graph, *, n_b: Optional[int] = None, backend: str = "dense",
           max_depth: Optional[int] = None, device="cuda") -> np.ndarray:
    """Full unweighted BC via the BFS baseline.

    Args:
      g: host COO graph with unit weights (raises ``ValueError``
        otherwise).
      n_b: batch size. Default min(n, 64).
      backend: "dense" or "coo".
      max_depth: BFS levels each sweep runs (default n - 1; any bound at
        or past the graph's largest BFS depth gives the same λ).
      device: "cuda" (default; raises if there is no card) or "cpu".

    Returns:
      λ: (n,) float64, the ordered-pair convention of ``mfbc``.
    """
    if not np.all(g.w == 1.0):
        raise ValueError("bfs_bc is the unweighted baseline: every arc "
                         "weight must be 1")
    dev = resolve_device(device)
    n = g.n
    if n_b is None:
        n_b = min(n, 64)
    if max_depth is None:
        max_depth = n - 1
    if backend == "dense":
        adj = dense_adj_from_graph(g, device=dev)
    elif backend == "coo":
        adj = coo_adj_from_graph(g, device=dev)
    else:
        raise ValueError(f"bfs_bc runs on 'dense' or 'coo', not {backend!r}")
    lam = np.zeros(n, dtype=np.float64)
    for b in range(-(-n // n_b)):
        chunk = np.arange(b * n_b, min((b + 1) * n_b, n), dtype=np.int32)
        valid = np.ones(chunk.shape[0], dtype=bool)
        if chunk.shape[0] < n_b:
            pad = n_b - chunk.shape[0]
            chunk = np.concatenate([chunk, np.zeros(pad, np.int32)])
            valid = np.concatenate([valid, np.zeros(pad, bool)])
        lam_b = bfs_bc_batch(adj, torch.from_numpy(chunk).to(dev),
                             torch.from_numpy(valid).to(dev),
                             max_depth=max_depth)
        lam += lam_b.cpu().numpy().astype(np.float64)
    return lam
