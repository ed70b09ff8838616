"""Pure-numpy Brandes betweenness centrality oracle.

Textbook Brandes [2001] with Dijkstra (weighted) or BFS (unweighted)
forward phases. Ordered-pair convention: λ(v) = Σ_{s≠t, v∉{s,t}}
σ(s,t,v)/σ̄(s,t) — identical to the paper's definition, no /2 for
undirected graphs. This is the ground truth for every MFBC correctness
test.

A copy of ``repro.core.brandes_ref``: that package's ``__init__`` imports
jax, so the port keeps its own.
"""
from __future__ import annotations

import heapq
from typing import Optional

import numpy as np

from repro_torch.graphs.formats import Graph, coo_to_csr


def brandes_bc(g: Graph, sources: Optional[np.ndarray] = None,
               return_aux: bool = False):
    """Betweenness centrality.

    Args:
      g: host graph with positive weights.
      sources: restrict the s-sum to these sources (default: all).
      return_aux: also return (dist, sigma) arrays of shape (n_src, n)
        — the MFBF oracle.
    """
    n = g.n
    indptr, indices, weights = coo_to_csr(g)
    tindptr, tindices, tweights = coo_to_csr(g.transpose())
    unweighted = bool(np.all(weights == 1.0))
    src_list = np.arange(n) if sources is None else np.asarray(sources)
    lam = np.zeros(n, dtype=np.float64)
    dists = np.full((len(src_list), n), np.inf) if return_aux else None
    sigmas = np.zeros((len(src_list), n)) if return_aux else None

    for si, s in enumerate(src_list):
        dist = np.full(n, np.inf)
        sigma = np.zeros(n, dtype=np.float64)
        dist[s] = 0.0
        sigma[s] = 1.0
        order = []  # vertices in nondecreasing finalized distance
        if unweighted:
            frontier = [int(s)]
            while frontier:
                order.extend(frontier)
                nxt = []
                for u in frontier:
                    for ei in range(indptr[u], indptr[u + 1]):
                        v = int(indices[ei])
                        nd = dist[u] + 1.0
                        if not np.isfinite(dist[v]):
                            dist[v] = nd
                            sigma[v] = sigma[u]
                            nxt.append(v)
                        elif nd == dist[v]:
                            sigma[v] += sigma[u]
                frontier = nxt
        else:
            done = np.zeros(n, dtype=bool)
            heap = [(0.0, int(s))]
            while heap:
                d, u = heapq.heappop(heap)
                if done[u] or d > dist[u]:
                    continue
                done[u] = True
                order.append(u)
                for ei in range(indptr[u], indptr[u + 1]):
                    v = int(indices[ei])
                    nd = d + weights[ei]
                    if nd < dist[v]:
                        dist[v] = nd
                        sigma[v] = sigma[u]
                        heapq.heappush(heap, (float(nd), v))
                    elif nd == dist[v]:
                        sigma[v] += sigma[u]

        # Backward dependency accumulation over incoming arcs:
        # v ∈ pred(u) iff dist[v] + w(v, u) == dist[u].
        delta = np.zeros(n, dtype=np.float64)
        for u in reversed(order):
            if u == s or not np.isfinite(dist[u]):
                continue
            for ei in range(tindptr[u], tindptr[u + 1]):
                v = int(tindices[ei])  # arc v -> u in the original graph
                if np.isfinite(dist[v]) and dist[v] + tweights[ei] == dist[u]:
                    delta[v] += sigma[v] / sigma[u] * (1.0 + delta[u])

        mask = np.ones(n, dtype=bool)
        mask[s] = False
        lam[mask] += delta[mask]
        if return_aux:
            dists[si] = dist
            sigmas[si] = sigma
    if return_aux:
        return lam, dists, sigmas
    return lam


# ==========================================================================
# Sibling-metric oracles (plain numpy BFS / Dijkstra / union-find) — the
# ground truth for the MetricSpec sweeps in ``repro.core.metrics``.
# ==========================================================================


def _sssp(g: Graph, s: int, indptr, indices, weights, unweighted: bool
          ) -> np.ndarray:
    """Single-source distances (BFS or Dijkstra), (n,) float64."""
    dist = np.full(g.n, np.inf)
    dist[s] = 0.0
    if unweighted:
        frontier = [int(s)]
        while frontier:
            nxt = []
            for u in frontier:
                for ei in range(indptr[u], indptr[u + 1]):
                    v = int(indices[ei])
                    if not np.isfinite(dist[v]):
                        dist[v] = dist[u] + 1.0
                        nxt.append(v)
            frontier = nxt
    else:
        heap = [(0.0, int(s))]
        while heap:
            d, u = heapq.heappop(heap)
            if d > dist[u]:
                continue
            for ei in range(indptr[u], indptr[u + 1]):
                v = int(indices[ei])
                nd = d + weights[ei]
                if nd < dist[v]:
                    dist[v] = nd
                    heapq.heappush(heap, (float(nd), v))
    return dist


def closeness_ref(g: Graph, sources: Optional[np.ndarray] = None
                  ) -> np.ndarray:
    """Farness oracle: F(v) = Σ_s τ(s, v) over finite distances, s ≠ v.

    The transpose of the usual closeness orientation — distances *into*
    v from each source — matching the sweep convention where row s of T
    holds τ(s, ·). Unreachable pairs contribute 0.
    """
    indptr, indices, weights = coo_to_csr(g)
    unweighted = bool(np.all(weights == 1.0))
    src_list = np.arange(g.n) if sources is None else np.asarray(sources)
    far = np.zeros(g.n, dtype=np.float64)
    for s in src_list:
        dist = _sssp(g, int(s), indptr, indices, weights, unweighted)
        dist[int(s)] = np.inf  # self-pair excluded, like d(s, s) = 0
        finite = np.isfinite(dist)
        far[finite] += dist[finite]
    return far


def khop_ref(g: Graph, sources: Optional[np.ndarray] = None, *,
             hops: int = 1) -> np.ndarray:
    """k-hop in-reachability oracle: R(v) = |{s : v within ``hops`` edges
    of s, v ≠ s}| — hop-limited BFS on the arc structure (weights
    ignored; hop counts are edge counts)."""
    if hops < 1:
        raise ValueError(f"khop requires hops >= 1, got {hops}")
    indptr, indices, _ = coo_to_csr(g)
    src_list = np.arange(g.n) if sources is None else np.asarray(sources)
    reach = np.zeros(g.n, dtype=np.float64)
    for s in src_list:
        depth = np.full(g.n, -1, dtype=np.int64)
        depth[int(s)] = 0
        frontier = [int(s)]
        for d in range(hops):
            nxt = []
            for u in frontier:
                for ei in range(indptr[u], indptr[u + 1]):
                    v = int(indices[ei])
                    if depth[v] < 0:
                        depth[v] = d + 1
                        nxt.append(v)
            frontier = nxt
        hit = depth >= 0
        hit[int(s)] = False
        reach[hit] += 1.0
    return reach


def cc_ref(g: Graph) -> np.ndarray:
    """Weakly-connected-components oracle: label(v) = min vertex id in
    v's component (union-find over the undirected arc structure)."""
    parent = np.arange(g.n, dtype=np.int64)

    def find(x: int) -> int:
        root = x
        while parent[root] != root:
            root = int(parent[root])
        while parent[x] != root:
            parent[x], x = root, int(parent[x])
        return root

    for u, v in zip(g.src.tolist(), g.dst.tolist()):
        ru, rv = find(int(u)), find(int(v))
        if ru != rv:
            # union by min id keeps the root the component minimum
            lo, hi = (ru, rv) if ru < rv else (rv, ru)
            parent[hi] = lo
    return np.array([find(v) for v in range(g.n)], dtype=np.float64)
