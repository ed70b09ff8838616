"""Architecture registry: ``--arch <id>`` resolution.

The port's registry holds every architecture of the reference's: the
five LMs, the four GNNs, xDeepFM and the paper's own ``mfbc_paper``.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec, BCArch, RecsysArch
from repro_torch.configs.gnn_archs import GAT_CORA, GCN_CORA, GIN_TU, NEQUIP
from repro_torch.configs.lm_archs import (COMMAND_R_PLUS, GEMMA2_27B,
                                          GRANITE_34B, MOONSHOT_16B,
                                          QWEN3_MOE)

ARCHS: Dict[str, ArchSpec] = {
    a.arch_id: a for a in [
        GEMMA2_27B, COMMAND_R_PLUS, GRANITE_34B, MOONSHOT_16B, QWEN3_MOE,
        GCN_CORA, GIN_TU, NEQUIP, GAT_CORA,
        RecsysArch(), BCArch(),
    ]
}
# the reference's architectures that a later slice of ROADMAP.md ports
UNPORTED: Dict[str, str] = {}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (slice "
            f"{UNPORTED[arch_id]} of ROADMAP.md)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells():
    """Every (arch_id, shape_id) dry-run cell."""
    out = []
    for aid, spec in ARCHS.items():
        for sid in spec.cells():
            out.append((aid, sid))
    return out
