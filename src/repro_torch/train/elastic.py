"""Elastic scaling: restore a running job onto a different mesh.

A port of ``repro/train/elastic.py``. At 1000+ node scale, node loss
means continuing on p' < p nodes (and re-expanding later). Checkpoints
are stored unsharded (``checkpoint.py``), so elasticity is: build the new
mesh → build a state tree placed on it → ``restore(..., like=new_like)``.
For MFBC specifically, the batch size ``n_b = c·m/n`` re-derives from the
new replication factor (paper §5.3.4: strong scaling holds from p₀ to
p₀^{3/2}·n²/m).
"""
from __future__ import annotations

from typing import Optional

from repro_torch.spgemm.cost_model import best_replication
from repro_torch.train import checkpoint as ckpt_lib


def reshard_checkpoint(ckpt_dir: str, new_like, step: Optional[int] = None):
    """Restore the latest checkpoint (or ``step``) placed like
    ``new_like``'s leaves."""
    return ckpt_lib.restore(ckpt_dir, step=step, like=new_like)


def bc_elastic_nb(n: int, m_edges: int, p: int, mem_bytes: float,
                  word: int = 8) -> int:
    """Re-derive the MFBC batch size for a new processor count (paper:
    n_b = c·m/n with c clamped by memory)."""
    c = best_replication(n, m_edges, p, mem_bytes, word=word)
    return max(1, int(c * m_edges / max(n, 1)))
