"""Neighbor sampler for sampled-training GNN cells (minibatch_lg).

GraphSAGE-style layered uniform fanout sampling from a CSR adjacency
[arXiv:1706.02216]. Produces *static-shape* padded subgraph arrays (jit
requirement): the node budget is seeds·(1 + f₁ + f₁·f₂ …) and the edge
budget seeds·f₁·(1 + f₂ …); real counts are carried in masks. The dummy
node sits at index ``n_budget`` (one-past-the-end), matching the GNN
forward conventions.

A copy of ``repro/graphs/sampler.py`` (numpy only, over the port's
``coo_to_csr``): the same seeds give the reference's arrays, bit for bit.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from repro_torch.graphs.formats import Graph, coo_to_csr


@dataclasses.dataclass(frozen=True)
class SamplerSpec:
    batch_nodes: int
    fanout: Tuple[int, ...]  # e.g. (15, 10)

    @property
    def node_budget(self) -> int:
        n, mult = self.batch_nodes, 1
        total = self.batch_nodes
        for f in self.fanout:
            mult *= f
            total += self.batch_nodes * mult
        return total

    @property
    def edge_budget(self) -> int:
        total, mult = 0, 1
        for f in self.fanout:
            mult *= f
            total += self.batch_nodes * mult
        return total


class NeighborSampler:
    def __init__(self, g: Graph, spec: SamplerSpec, seed: int = 0):
        self.spec = spec
        self.n = g.n
        self.indptr, self.indices, _ = coo_to_csr(g)
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> Dict[str, np.ndarray]:
        """Returns padded subgraph with *local* node ids.

        keys: node_ids (Nb+1,) original ids (pad = n), src/dst (Eb,) local,
        edge_pad (Eb,) bool, seed_mask (Nb+1,) bool.
        """
        spec = self.spec
        assert seeds.shape[0] == spec.batch_nodes
        nodes = [seeds.astype(np.int64)]
        edges_src, edges_dst = [], []
        frontier = seeds.astype(np.int64)
        base = 0
        for f in spec.fanout:
            deg = self.indptr[frontier + 1] - self.indptr[frontier]
            # uniform sample f neighbors per frontier node (with replacement;
            # degree-0 nodes sample the dummy)
            r = self.rng.integers(0, 1 << 62, size=(frontier.shape[0], f))
            idx = np.where(deg[:, None] > 0, r % np.maximum(deg[:, None], 1), -1)
            nbr = np.where(
                idx >= 0,
                self.indices[self.indptr[frontier][:, None] + np.maximum(idx, 0)],
                -1)
            nodes.append(nbr.reshape(-1))
            new_base = sum(x.shape[0] for x in nodes[:-1])
            edges_src.append(new_base + np.arange(nbr.size))
            edges_dst.append(base + np.repeat(np.arange(frontier.shape[0]), f))
            base = new_base
            frontier = np.maximum(nbr.reshape(-1), 0)
        node_ids = np.concatenate(nodes)
        src = np.concatenate(edges_src)
        dst = np.concatenate(edges_dst)
        pad = node_ids[src] < 0  # sampled from degree-0: dummy edge
        nb = spec.node_budget
        node_ids_p = np.full(nb + 1, self.n, dtype=np.int64)
        node_ids_p[:node_ids.shape[0]] = np.where(node_ids < 0, self.n,
                                                  node_ids)
        src_p = np.where(pad, nb, src).astype(np.int32)
        dst_p = dst.astype(np.int32)
        seed_mask = np.zeros(nb + 1, bool)
        seed_mask[:spec.batch_nodes] = True
        return {
            "node_ids": node_ids_p,
            "src": src_p,
            "dst": dst_p,
            "edge_pad": pad,
            "seed_mask": seed_mask,
        }


def batch_molecules(n_graphs: int, n_nodes: int, n_edges: int, d_in: int,
                    seed: int = 0) -> Dict[str, np.ndarray]:
    """Block-diagonal batch of random small molecules (molecule cell)."""
    rng = np.random.default_rng(seed)
    N = n_graphs * n_nodes
    pos = rng.normal(size=(N + 1, 3)).astype(np.float32) * 2.0
    x = rng.normal(size=(N + 1, d_in)).astype(np.float32)
    src = np.zeros(n_graphs * n_edges, np.int32)
    dst = np.zeros(n_graphs * n_edges, np.int32)
    for gi in range(n_graphs):
        off = gi * n_nodes
        s = rng.integers(0, n_nodes, n_edges)
        shift = 1 + rng.integers(0, n_nodes - 1, n_edges)
        d = (s + shift) % n_nodes
        src[gi * n_edges:(gi + 1) * n_edges] = off + s
        dst[gi * n_edges:(gi + 1) * n_edges] = off + d
    graph_ids = np.repeat(np.arange(n_graphs), n_nodes)
    graph_ids = np.concatenate([graph_ids, [n_graphs]]).astype(np.int32)
    return {"pos": pos, "x": x, "src": src, "dst": dst,
            "graph_ids": graph_ids, "n_graphs": n_graphs + 1,
            "energy": rng.normal(size=n_graphs + 1).astype(np.float32)}
