"""Architecture registry: ``--arch <id>`` resolution.

The port's registry holds the five LM architectures, the four GNNs and
xDeepFM. The reference's BC id names the slice of ROADMAP.md that ports
it.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import ArchSpec, RecsysArch
from repro_torch.configs.gnn_archs import GAT_CORA, GCN_CORA, GIN_TU, NEQUIP
from repro_torch.configs.lm_archs import (COMMAND_R_PLUS, GEMMA2_27B,
                                          GRANITE_34B, MOONSHOT_16B,
                                          QWEN3_MOE)

ARCHS: Dict[str, ArchSpec] = {
    a.arch_id: a for a in [
        GEMMA2_27B, COMMAND_R_PLUS, GRANITE_34B, MOONSHOT_16B, QWEN3_MOE,
        GCN_CORA, GIN_TU, NEQUIP, GAT_CORA,
        RecsysArch(),
    ]
}
# the reference's architectures that later slices port
UNPORTED = {"mfbc_paper": "7d"}


def get_arch(arch_id: str) -> ArchSpec:
    if arch_id in UNPORTED:
        raise NotImplementedError(
            f"arch {arch_id!r} is not ported yet (slice "
            f"{UNPORTED[arch_id]} of ROADMAP.md)")
    if arch_id not in ARCHS:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(ARCHS)}")
    return ARCHS[arch_id]


def all_cells():
    """Every (arch_id, shape_id) cell of the ported architectures."""
    out = []
    for aid, spec in ARCHS.items():
        for sid in spec.cells():
            out.append((aid, sid))
    return out
