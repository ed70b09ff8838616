"""LM transformers (dense + MoE) of the architecture zoo. The GNNs and
xDeepFM (``gnn``, ``recsys``) are slice 7c of ROADMAP.md."""
from repro_torch.models import layers, transformer

__all__ = ["layers", "transformer"]
