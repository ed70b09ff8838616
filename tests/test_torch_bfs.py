"""The port's BFS baseline (``repro_torch.core.bfs_bc``) against the JAX
package's and the Brandes oracle (CPU only).

Unweighted graphs from the byte-equal generators: λ equal to the
reference's ``bfs_bc`` and to ``brandes_bc`` (rtol 1e-5, atol 1e-8) on the
dense and COO backends, at the default ``max_depth`` (n - 1) and at the
graph's own BFS depth; one batch against the reference's batch on the
same adjacency arrays within rtol 1e-6 (float32 sums over the rows, in
another order). A weighted graph is refused, as the reference
refuses it (it asserts; the port raises ``ValueError``).
"""
import numpy as np
import pytest
import torch

import repro.core.adjacency as jadj
from repro.core.bfs_bc import bfs_bc as jax_bfs_bc
from repro.core.bfs_bc import bfs_bc_batch as jax_bfs_batch
import repro_torch.core.adjacency as tadj
from repro_torch.core.bfs_bc import bfs_bc, bfs_bc_batch
from repro_torch.core.brandes_ref import brandes_bc
from repro_torch.graphs.generators import path_graph, ring_of_cliques, rmat

GRAPHS = {
    "rmat5": lambda: rmat(5, 4, seed=1).remove_isolated()[0],
    "rmat6_directed": lambda: rmat(6, 3, seed=4,
                                   directed=True).remove_isolated()[0],
    "ring_of_cliques": lambda: ring_of_cliques(4, 4),
    "path": lambda: path_graph(9),
}


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _depth(g) -> int:
    """The largest BFS depth over all sources (scipy)."""
    from scipy.sparse import csr_matrix
    from scipy.sparse.csgraph import shortest_path

    hops = shortest_path(csr_matrix((np.ones(g.nnz), (g.src, g.dst)),
                                    shape=(g.n, g.n)), unweighted=True)
    return int(hops[np.isfinite(hops)].max())


@pytest.mark.parametrize("backend", ["dense", "coo"])
@pytest.mark.parametrize("name", sorted(GRAPHS))
def test_bfs_bc_matches_reference_and_brandes(name, backend):
    g = GRAPHS[name]()
    want = brandes_bc(g)
    lam = bfs_bc(g, n_b=8, backend=backend, device="cpu")
    np.testing.assert_allclose(lam, want, rtol=1e-5, atol=1e-8)
    np.testing.assert_allclose(
        lam, jax_bfs_bc(g, n_b=8, backend=backend), rtol=1e-5, atol=1e-8)
    # levels past the deepest one are empty: the graph's depth suffices
    shallow = bfs_bc(g, n_b=8, backend=backend, max_depth=_depth(g),
                     device="cpu")
    np.testing.assert_array_equal(shallow, lam)


@pytest.mark.parametrize("backend", ["dense", "coo"])
def test_bfs_batch_matches_reference(backend):
    g = GRAPHS["rmat6_directed"]()
    if backend == "dense":
        r = jadj.dense_adj_from_graph(g)
        ours = tadj.dense_adj_from_arrays(np.asarray(r.a), np.asarray(r.at),
                                          device="cpu")
    else:
        r = jadj.coo_adj_from_graph(g)
        ours = tadj.coo_adj_from_arrays(*(np.asarray(x) for x in
                                          (r.src, r.dst, r.w)), r.n,
                                        device="cpu")
    src = np.random.default_rng(2).integers(0, g.n, 12).astype(np.int32)
    valid = np.arange(12) < 10
    depth = _depth(g)
    got = bfs_bc_batch(ours, torch.from_numpy(src), torch.from_numpy(valid),
                       max_depth=depth)
    want = jax_bfs_batch(r, src, valid, max_depth=depth)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_bfs_bc_refuses_weights_and_unknown_backends():
    g = rmat(5, 4, seed=1, weighted=True, max_weight=5).remove_isolated()[0]
    with pytest.raises(AssertionError):
        jax_bfs_bc(g)
    with pytest.raises(ValueError, match="unweighted"):
        bfs_bc(g, device="cpu")
    with pytest.raises(ValueError, match="'dense' or 'coo'"):
        bfs_bc(path_graph(4), backend="csr", device="cpu")


def test_bfs_bc_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        bfs_bc(path_graph(4))
