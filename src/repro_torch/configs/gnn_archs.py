"""The four assigned GNN architectures.

A copy of ``repro/configs/gnn_archs.py``, field for field.
"""
from repro_torch.configs.base import GNNArch

# gcn-cora [arXiv:1609.02907]: 2 layers, 16 hidden, mean/sym-norm agg.
GCN_CORA = GNNArch(
    "gcn-cora", "gcn",
    full_hp=dict(n_layers=2, d_hidden=16),
    smoke_hp=dict(n_layers=2, d_hidden=8))

# gin-tu [arXiv:1810.00826]: 5 layers, 64 hidden, sum agg, learnable eps.
GIN_TU = GNNArch(
    "gin-tu", "gin",
    full_hp=dict(n_layers=5, d_hidden=64, learn_eps=True),
    smoke_hp=dict(n_layers=2, d_hidden=16, learn_eps=True))

# nequip [arXiv:2101.03164]: 5 layers, 32 channels, l_max=2, 8 rbf,
# cutoff 5 Å — realized in the Cartesian tensor basis (DESIGN.md §3).
NEQUIP = GNNArch(
    "nequip", "nequip",
    full_hp=dict(n_layers=5, channels=32, l_max=2, n_rbf=8, cutoff=5.0),
    smoke_hp=dict(n_layers=2, channels=8, l_max=2, n_rbf=4, cutoff=5.0))

# gat-cora [arXiv:1710.10903]: 2 layers, 8 hidden x 8 heads.
GAT_CORA = GNNArch(
    "gat-cora", "gat",
    full_hp=dict(n_layers=2, d_hidden=8, n_heads=8),
    smoke_hp=dict(n_layers=2, d_hidden=4, n_heads=2))
