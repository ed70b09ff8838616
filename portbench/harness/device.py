"""The card: the look for one, its name and power limit, and the modules
that may not be loaded in the process that prints the result."""
from __future__ import annotations

import subprocess
import sys
from typing import List

# Compared by each loaded module's top-level name (the part before the
# first dot), whole: ``repro_torch`` is the program, ``repro`` the JAX
# package it was ported from.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def require_cards(chips: int) -> None:
    """Exit, printing no result, unless ``chips`` CUDA cards are here."""
    import torch

    if not torch.cuda.is_available():
        sys.exit("portbench: no CUDA card is available")
    if torch.cuda.device_count() < chips:
        sys.exit(f"portbench: the cell needs {chips} cards, "
                 f"{torch.cuda.device_count()} are visible")


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of each card, or why not."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip().replace("\n", " | ") or out.stderr.strip()


def forbidden_modules() -> List[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".", 1)[0] in FORBIDDEN)
