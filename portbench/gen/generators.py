"""The benchmark's own graph generators: a frozen numpy copy.

Copied from ``src/repro_torch/graphs/generators.py`` (``erdos_renyi``,
``rmat``) and ``src/repro_torch/graphs/formats.py`` (``Graph.dedup``,
``symmetrize``, ``remove_isolated``), so that the inputs a cell runs on
cannot change when the program changes. Each function works on plain
arrays ``(n, src, dst, w)``: int32 ids, float32 weights. The same seed
gives byte-identical arrays to the port's generators
(``portbench/tests/test_portbench_gen.py``). ``permute_vertices`` is the
benchmark's own: Graph500's relabelling, which the port's pipeline does
not do.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

Arcs = Tuple[int, np.ndarray, np.ndarray, np.ndarray]  # (n, src, dst, w)


def _arcs(n: int, src, dst, w) -> Arcs:
    return (int(n), np.asarray(src, np.int32), np.asarray(dst, np.int32),
            np.asarray(w, np.float32))


def _weights(rng: np.random.Generator, nnz: int, weighted: bool,
             max_weight: int) -> np.ndarray:
    if weighted:
        return rng.integers(1, max_weight + 1, size=nnz).astype(np.float32)
    return np.ones(nnz, dtype=np.float32)


def dedup(g: Arcs) -> Arcs:
    """Keep the minimum-weight arc for each (src, dst) pair; drop loops."""
    n, src, dst, w = g
    keep = src != dst
    src, dst, w = src[keep], dst[keep], w[keep]
    key = src.astype(np.int64) * n + dst.astype(np.int64)
    order = np.lexsort((w, key))
    key, src, dst, w = key[order], src[order], dst[order], w[order]
    first = np.ones(key.shape[0], dtype=bool)
    first[1:] = key[1:] != key[:-1]
    return _arcs(n, src[first], dst[first], w[first])


def symmetrize(g: Arcs) -> Arcs:
    """Both arcs of every edge, deduped."""
    n, src, dst, w = g
    return dedup(_arcs(n, np.concatenate([src, dst]),
                       np.concatenate([dst, src]), np.concatenate([w, w])))


def remove_isolated(g: Arcs) -> Arcs:
    """Drop vertices with no incident arc and renumber the rest in order."""
    n, src, dst, w = g
    touched = np.zeros(n, dtype=bool)
    touched[src] = True
    touched[dst] = True
    kept = np.nonzero(touched)[0]
    remap = np.full(n, -1, dtype=np.int32)
    remap[kept] = np.arange(kept.shape[0], dtype=np.int32)
    return _arcs(kept.shape[0], remap[src], remap[dst], w)


def permute_vertices(g: Arcs, seed: int) -> Arcs:
    """Relabel the vertices by a permutation drawn from ``seed``, as
    Graph500's generator does, so that no id order carries the degrees;
    the arcs are left in their order."""
    n, src, dst, w = g
    label = np.random.default_rng([seed, 3]).permutation(n).astype(np.int32)
    return _arcs(n, label[src], label[dst], w)


def erdos_renyi(n: int, p_edge: float, *, seed: int, weighted: bool = False,
                max_weight: int = 100) -> Arcs:
    """Undirected G(n, p): a Poisson number of uniform arcs, deduped and
    symmetrized."""
    rng = np.random.default_rng(seed)
    expected = p_edge * n * (n - 1)
    nnz = (int(rng.poisson(expected)) if expected < n * (n - 1) * 0.5
           else int(expected))
    nnz = max(nnz, 1)
    src = rng.integers(0, n, size=nnz).astype(np.int32)
    dst = rng.integers(0, n, size=nnz).astype(np.int32)
    w = _weights(rng, nnz, weighted, max_weight)
    return symmetrize(dedup(_arcs(n, src, dst, w)))


def rmat(scale: int, edge_factor: int, *, seed: int, a: float = 0.57,
         b: float = 0.19, c: float = 0.19, weighted: bool = False,
         max_weight: int = 100) -> Arcs:
    """Undirected R-MAT with n = 2**scale and n·edge_factor drawn arcs."""
    n = 1 << scale
    nnz = n * edge_factor
    rng = np.random.default_rng(seed)
    src = np.zeros(nnz, dtype=np.int64)
    dst = np.zeros(nnz, dtype=np.int64)
    for _ in range(scale):
        r = rng.random(nnz)
        right = (r >= a) & (r < a + b) | (r >= a + b + c)
        down = r >= a + b
        src = src * 2 + down
        dst = dst * 2 + right
    w = _weights(rng, nnz, weighted, max_weight)
    return symmetrize(dedup(_arcs(n, src, dst, w)))
