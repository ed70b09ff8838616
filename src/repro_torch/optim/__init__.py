"""repro_torch.optim — AdamW and gradient compression on trees of
tensors (``repro_torch.tree``): a port of ``repro.optim``."""
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig

__all__ = ["adamw", "AdamWConfig"]
