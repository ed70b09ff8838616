"""One run of one cell: look for the cards, hand the cell to its traffic
mix's driver, read the per-layer metrics, refuse a process that loaded
JAX, print the result."""
from __future__ import annotations

from pathlib import Path

from portbench.harness import device as D
from portbench.harness import result as R
from portbench.harness import spec as S


def run_cell(name: str, *, seed: int, seconds: float, traced: bool,
             device: str, t_start: float, root: Path = S.ROOT) -> int:
    cell = S.load_cell(name, root=root)
    if device == "cuda":
        D.require_cards(cell.chips)
    import torch

    D.log(f"torch {torch.__version__}, cell {cell.name}: config "
          f"{cell.config_name}, traffic {cell.traffic_name}, "
          f"{cell.chips} chip(s), seed {seed}, {seconds} s, "
          f"trace {int(traced)}")
    record = S.load_driver(cell).run(cell, seed=seed, seconds=seconds,
                                     traced=traced, t_start=t_start,
                                     device=device)
    if device == "cuda":
        D.log(f"cards: {D.card_line()}")
    found = D.forbidden_modules()
    if found:
        D.log(f"refused: the process loaded {', '.join(found)}")
        return 3
    metrics = S.read_metrics(cell, record.layers) if traced else {}
    R.emit(R.line(cell, record, traced, metrics))
    return 0
