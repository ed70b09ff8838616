#!/usr/bin/env python3
"""``chip_smoke.py`` phase 9b over NCCL, one card a rank.

    python3 tools/torch_mesh_cards.py

Needs four cards; refuses to start with fewer. It runs phase 9b itself
(``chip_smoke.phase9b``, whose ranks put rank r on card r when there are
several cards) with ``backend="nccl"``: four spawned ranks on the (2, 2)
and (2, 1, 2) meshes at R-MAT scale 14 (the mean seconds of
``chip_smoke.MESH_REPEATS`` 64-source batches after the first, and each
rank's collective bytes a batch by kind beside ``model_mesh_bytes``),
exact λ at scale 12, the (ε, δ) = (0.1, 0.1) solve, the streamed upload,
and serving on (2, 2) behind the HTTP gateway with ranks 1–3 following.
Each is held to phase 9b's checks against the single-host dense path on
card 0. Prints the cards' names and power limits, phase 9b's lines, and
last one JSON object of the numbers.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

RANKS = 4


def main() -> None:
    if not torch.cuda.is_available() or torch.cuda.device_count() < RANKS:
        sys.exit(f"torch_mesh_cards: needs {RANKS} CUDA cards, found "
                 f"{torch.cuda.device_count()}")
    import chip_smoke as smoke

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[cards] nvidia-smi: {smi.replace(chr(10), ' | ')}", flush=True)
    smoke._build.build_all()
    g12 = smoke.graph(12)
    lam12 = smoke.mfbc(g12, n_b=64, device="cuda")  # phase 3's λ
    launches = {name: 0 for name in smoke.DENSE_PATH}
    report = smoke.phase9b(g12, np.asarray(lam12), launches, backend="nccl")
    report.update(cards_smi=smi.splitlines(), launches=launches)
    print(json.dumps(report), flush=True)


if __name__ == "__main__":
    main()
