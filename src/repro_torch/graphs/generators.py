"""Synthetic graph generators used by the paper's evaluation (Section 7).

A copy of ``repro.graphs.generators``: the same seed gives byte-identical
graphs in both packages.

* ``erdos_renyi`` — uniform random graphs [Gilbert 1959], used for the
  weak-scaling experiments.
* ``rmat`` — power-law R-MAT graphs [Chakrabarti et al. 2004], used for the
  strong-scaling experiments (S = log2 n, E = average degree).
* ``uniform_random`` — fixed-expected-degree uniform graphs, the paper's
  "vertex weak scaling" family.
* ``ring_of_cliques`` — a structured graph with analytically known
  betweenness, handy for exact unit tests.

All generators are deterministic in ``seed`` and produce positive integer
weights in ``[1, max_weight]`` (the paper uses integers in [1, 100]) or
unit weights when ``weighted=False``.
"""
from __future__ import annotations

import numpy as np

from repro_torch.graphs.formats import Graph


def _weights(rng: np.random.Generator, nnz: int, weighted: bool, max_weight: int
             ) -> np.ndarray:
    if weighted:
        return rng.integers(1, max_weight + 1, size=nnz).astype(np.float32)
    return np.ones(nnz, dtype=np.float32)


def from_spec(kind: str, *, scale: int, degree: float = 8,
              weighted: bool = False, seed: int = 0,
              max_weight: int = 100) -> Graph:
    """The shared CLI/benchmark graph family spec: kind + (scale, degree).

    ``kind`` is one of ``"rmat"`` (power-law, n = 2^scale, E = degree),
    ``"uniform"`` (fixed expected degree) or ``"er"`` (Erdős–Rényi with
    p = degree/n). One helper so ``launch.bc_run``, the benchmarks and
    the tests all build byte-identical graphs from the same flags.
    """
    n = 1 << scale
    if kind == "rmat":
        return rmat(scale, int(degree), weighted=weighted, seed=seed,
                    max_weight=max_weight)
    if kind == "uniform":
        return uniform_random(n, degree, weighted=weighted, seed=seed,
                              max_weight=max_weight)
    if kind == "er":
        return erdos_renyi(n, degree / n, weighted=weighted, seed=seed,
                           max_weight=max_weight)
    raise ValueError(f"unknown graph kind {kind!r} "
                     f"(expected rmat | uniform | er)")


def erdos_renyi(n: int, p_edge: float, *, seed: int = 0, weighted: bool = False,
                max_weight: int = 100, directed: bool = False) -> Graph:
    rng = np.random.default_rng(seed)
    # Sample the number of arcs then arc endpoints — O(m) not O(n^2).
    expected = p_edge * n * (n - 1)
    nnz = int(rng.poisson(expected)) if expected < n * (n - 1) * 0.5 else int(expected)
    nnz = max(nnz, 1)
    src = rng.integers(0, n, size=nnz).astype(np.int32)
    dst = rng.integers(0, n, size=nnz).astype(np.int32)
    w = _weights(rng, nnz, weighted, max_weight)
    g = Graph(n, src, dst, w, directed=directed, name=f"er_n{n}_p{p_edge}").dedup()
    return g if directed else g.symmetrize()


def uniform_random(n: int, avg_degree: float, *, seed: int = 0,
                   weighted: bool = False, max_weight: int = 100,
                   directed: bool = False) -> Graph:
    return erdos_renyi(n, avg_degree / max(n - 1, 1), seed=seed, weighted=weighted,
                       max_weight=max_weight, directed=directed)


def rmat(scale: int, avg_degree: int, *, a: float = 0.57, b: float = 0.19,
         c: float = 0.19, seed: int = 0, weighted: bool = False,
         max_weight: int = 100, directed: bool = False) -> Graph:
    """R-MAT generator with the Graph500 default (a, b, c, d) quadrant mix."""
    n = 1 << scale
    nnz = n * avg_degree
    rng = np.random.default_rng(seed)
    src = np.zeros(nnz, dtype=np.int64)
    dst = np.zeros(nnz, dtype=np.int64)
    for level in range(scale):
        r = rng.random(nnz)
        # Quadrant picks: P(a)=a, P(b)=b, P(c)=c, P(d)=1-a-b-c.
        right = (r >= a) & (r < a + b) | (r >= a + b + c)
        down = r >= a + b
        src = src * 2 + down
        dst = dst * 2 + right
    w = _weights(rng, nnz, weighted, max_weight)
    g = Graph(n, src.astype(np.int32), dst.astype(np.int32), w,
              directed=directed, name=f"rmat_s{scale}_e{avg_degree}").dedup()
    return g if directed else g.symmetrize()


def ring_of_cliques(n_cliques: int, clique_size: int, *, weighted: bool = False,
                    seed: int = 0, max_weight: int = 10) -> Graph:
    """``n_cliques`` cliques joined in a ring by single bridge edges."""
    rng = np.random.default_rng(seed)
    n = n_cliques * clique_size
    src, dst = [], []
    for q in range(n_cliques):
        base = q * clique_size
        for i in range(clique_size):
            for j in range(clique_size):
                if i != j:
                    src.append(base + i)
                    dst.append(base + j)
        nxt = ((q + 1) % n_cliques) * clique_size
        src += [base, nxt]
        dst += [nxt, base]
    src = np.asarray(src, np.int32)
    dst = np.asarray(dst, np.int32)
    w = _weights(rng, src.shape[0], weighted, max_weight)
    if weighted:
        # keep symmetric weights
        key = {}
        for e in range(src.shape[0]):
            k = (min(src[e], dst[e]), max(src[e], dst[e]))
            if k in key:
                w[e] = key[k]
            else:
                key[k] = w[e]
    return Graph(n, src, dst, w, directed=False,
                 name=f"roc_{n_cliques}x{clique_size}").dedup()


def star_graph(n: int, *, weighted: bool = False, seed: int = 0,
               max_weight: int = 10) -> Graph:
    """Hub vertex 0 joined to ``n-1`` leaves.

    The adaptive sampler's best case: every leaf source has the identical
    dependency profile (δ_s(hub) = n-2, zero elsewhere), so the empirical
    variance collapses and Bernstein/CLT stopping certifies ε long before
    the variance-free Hoeffding budget is spent.
    """
    rng = np.random.default_rng(seed)
    leaves = np.arange(1, n, dtype=np.int32)
    src = np.concatenate([np.zeros(n - 1, np.int32), leaves])
    dst = np.concatenate([leaves, np.zeros(n - 1, np.int32)])
    half = _weights(rng, n - 1, weighted, max_weight)
    w = np.concatenate([half, half])
    return Graph(n, src, dst, w, directed=False, name=f"star_{n}")


def path_graph(n: int, *, weighted: bool = False, seed: int = 0,
               max_weight: int = 10) -> Graph:
    rng = np.random.default_rng(seed)
    s = np.arange(n - 1, dtype=np.int32)
    src = np.concatenate([s, s + 1])
    dst = np.concatenate([s + 1, s])
    half = _weights(rng, n - 1, weighted, max_weight)
    w = np.concatenate([half, half])
    return Graph(n, src, dst, w, directed=False, name=f"path_{n}")
