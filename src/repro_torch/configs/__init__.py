"""Architectures × input-shape cells: the LM, GNN and recsys families of
``repro.configs``."""
from repro_torch.configs.base import ArchSpec, Cell, StepBundle
from repro_torch.configs.registry import ARCHS, all_cells, get_arch

__all__ = ["ArchSpec", "Cell", "StepBundle", "ARCHS", "all_cells",
           "get_arch"]
