#!/usr/bin/env python3
"""The control of a cell's check: the reference in bfloat16 put in the
program's place.

    python3 portbench/tools/control.py --workload rmat20.auto \\
        --seeds 41 42 43 [--device cuda]

The configuration states float32; the nearest precision below it with no
matrix product to take TF32 is bfloat16. For each seed this takes the
batches the cell's window would sweep first (as many as its check
samples, at the cell's batch), computes each batch's λ with the
reference in bfloat16 and in float64, and prints the compared number,
``lam_rel_err``, of the bfloat16 answers: the control's reading, which
has to lie over the cell's limit.
"""
from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def cell_batch(cell, n: int, src, dst, w, device: str) -> int:
    """The batch the cell's window runs at: pinned by its mix, or the
    program's planner's for ``device``."""
    from portbench.drivers.exact_sweep import query

    q = query(cell)
    if q.n_b is not None:
        return q.n_b
    from repro_torch.bc import plan
    from repro_torch.graphs.formats import Graph

    return plan(Graph(n, src, dst, w, directed=False), q,
                n_devices=cell.chips, device=device).n_b


def reading(arcs, nb: int, seed: int, device: str, batches: int) -> float:
    """The control's lam_rel_err over the first ``batches`` batches the
    window of ``seed`` sweeps on the graph ``arcs``."""
    import torch

    from portbench.drivers.exact_sweep import Sources
    from portbench.harness.result import lam_rel_err
    from portbench.reference.brandes import batch_lambda

    n, src, dst, w = arcs
    pick = Sources(n, nb, seed)
    worst = 0.0
    for i in range(batches):
        sources = pick.window(i)
        want = batch_lambda(n, src, dst, w, sources, dtype=torch.float64,
                            device=device)
        got = batch_lambda(n, src, dst, w, sources, dtype=torch.bfloat16,
                           device=device)
        worst = max(worst, lam_rel_err(got, want))
    return worst


def cell_reading(cell, seed: int, device: str) -> float:
    """The control's reading at the cell's own size and batch."""
    from portbench.harness import graphs

    arcs = graphs.load(cell.config, cell.root)
    return reading(arcs, cell_batch(cell, *arcs, device), seed, device,
                   int(cell.workload["check"]["batches"]))


def main() -> None:
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.harness.spec import load_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    cell = load_cell(a.workload)
    limit = cell.workload["check"]["limits"]["lam_rel_err"]
    for seed in a.seeds:
        t0 = time.perf_counter()
        r = cell_reading(cell, seed, a.device)
        print(f"[control] {a.workload} seed {seed}: bfloat16 reference "
              f"lam_rel_err {r!r} (limit {limit!r}, "
              f"{'fails' if not r <= limit else 'PASSES'}) "
              f"{time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
