"""Train a GNN (GCN) with the real neighbor sampler, and an equivariant
NequIP-class model on molecule batches, on the PyTorch port.

The port's counterpart of ``examples/gnn_train.py``: the same graphs,
batches, models and optimizer settings, through
``repro_torch.train.train_lib.make_generic_train_step``.

  PYTHONPATH=src python examples/torch_gnn_train.py [--device cpu]
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.base import batch_to_torch
from repro_torch.graphs.generators import erdos_renyi
from repro_torch.graphs.sampler import (NeighborSampler, SamplerSpec,
                                        batch_molecules)
from repro_torch.models import gnn as G
from repro_torch.optim import adamw
from repro_torch.train.train_lib import make_generic_train_step

GCN_CFG = G.GCNConfig("gcn-sampled", d_in=16, d_hidden=16, n_classes=4)
NEQUIP_CFG = G.NequIPConfig("nequip-demo", n_layers=3, channels=16, d_in=8)
GCN_STEPS, NEQUIP_STEPS = 40, 60


def gcn_batches(steps: int):
    """The reference example's neighbor-sampled batches (numpy), one a
    step: 16 seeds of a 500-node G(n, 0.02), fanout (5, 3)."""
    g = erdos_renyi(500, 0.02, seed=0)
    spec = SamplerSpec(batch_nodes=16, fanout=(5, 3))
    sampler = NeighborSampler(g, spec, seed=1)
    feats = np.random.default_rng(0).normal(size=(g.n + 1, 16)).astype(
        np.float32)
    labels = np.random.default_rng(1).integers(0, 4, g.n + 1).astype(
        np.int32)
    for step in range(steps):
        rng = np.random.default_rng(step)
        seeds = rng.choice(g.n, spec.batch_nodes, replace=False)
        sub = sampler.sample(seeds.astype(np.int64))
        ids = np.minimum(sub["node_ids"], g.n)
        deg = np.bincount(sub["dst"], minlength=ids.shape[0])
        yield {"x": feats[ids], "src": sub["src"], "dst": sub["dst"],
               "deg": deg.astype(np.float32), "labels": labels[ids],
               "label_mask": sub["seed_mask"]}


def nequip_batch():
    """The reference example's fixed molecule batch (numpy) and its
    static graph count: 8 molecules of 6 atoms and 12 edges."""
    mol = batch_molecules(8, 6, 12, d_in=8, seed=0)
    return mol, mol.pop("n_graphs")


def train_gcn_sampled(device="cuda", params=None):
    """The GCN loop; ``params`` (a tree on ``device``) replaces the drawn
    initial parameters. Returns the losses."""
    init_fn, step_fn = make_generic_train_step(
        lambda p, b: G.node_ce_loss("gcn", GCN_CFG, p, b),
        lambda gen: params if params is not None else G.gcn_init(
            GCN_CFG, gen, device),
        adamw.AdamWConfig(lr=5e-3))
    state = init_fn(torch.Generator().manual_seed(0))
    losses = []
    for batch in gcn_batches(GCN_STEPS):
        state, m = step_fn(state, batch_to_torch(batch, device))
        losses.append(float(m["loss"]))
    return losses


def train_nequip(device="cuda", params=None):
    """The NequIP loop on one fixed molecule batch; ``params`` as
    ``train_gcn_sampled``'s. Returns the losses."""
    mol, n_graphs = nequip_batch()

    def loss(p, batch):
        return G.energy_mse_loss(NEQUIP_CFG, p, dict(batch,
                                                    n_graphs=n_graphs))

    init_fn, step_fn = make_generic_train_step(
        loss, lambda gen: params if params is not None else G.nequip_init(
            NEQUIP_CFG, gen, device),
        adamw.AdamWConfig(lr=2e-3))
    state = init_fn(torch.Generator().manual_seed(1))
    batch = batch_to_torch(mol, device)
    losses = []
    for _ in range(NEQUIP_STEPS):
        state, m = step_fn(state, batch)
        losses.append(float(m["loss"]))
    return losses


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    losses = train_gcn_sampled(args.device)
    print(f"GCN (neighbor-sampled): loss {losses[0]:.3f} -> "
          f"{np.mean(losses[-5:]):.3f}")
    assert np.mean(losses[-5:]) < losses[0]
    losses = train_nequip(args.device)
    print(f"NequIP (molecules):     loss {np.mean(losses[:5]):.3f} -> "
          f"{np.mean(losses[-5:]):.3f}")
    assert np.mean(losses[-5:]) < np.mean(losses[:5])
    print("GNN training converges")


if __name__ == "__main__":
    main()
