"""The architecture zoo: LM transformers (dense + MoE), the GNNs
(``gnn``; the 2D edge-partitioned GCN in ``gnn_dist``) and xDeepFM
(``recsys``)."""
from repro_torch.models import gnn, layers, recsys, transformer

__all__ = ["gnn", "layers", "recsys", "transformer"]
