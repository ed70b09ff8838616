#!/usr/bin/env python3
"""The control of the served cell's check: the reference in bfloat16 put
in the program's place.

    python3 portbench/tools/served_control.py \\
        --workload rmat20-serve.topk16 --seeds 41 42 43 [--device cuda]

For each seed this draws as many requests as the cell's check samples at
least (``check.requests``), each of an equal share of its sources
(``check.sources``), uniformly from the vertices. Each request's answer
is what the reference computes in bfloat16 (the nearest precision below
the configuration's float32 with no matrix product to take TF32): λ̂ over
its sources, its top k, their λ̂ and their normal-rule halfwidths at the
mix's δ; it claims no convergence and its cap is its sources, so its
stop is legal. The answers go through the cell's own check
(``drivers/served_sweep.check_answers``) against the reference in
float64, and the compared numbers are printed beside their limits: the
control has to exceed at least one.
"""
from __future__ import annotations

import argparse
import math
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def reading(arcs, check: dict, mix: dict, seed: int, device: str) -> dict:
    """The control's compared numbers, by name: (value, limit)."""
    import numpy as np
    import torch

    from portbench.drivers.served_sweep import Answer, check_answers
    from portbench.harness import graphs
    from portbench.reference.sampled import (halfwidths, sampled_moments,
                                             top_k)

    n, src, dst, w = arcs
    dev = "cuda:0" if device == "cuda" else "cpu"
    requests = int(check["requests"])
    per = math.ceil(int(check["sources"]) / requests)
    rng = np.random.default_rng([graphs.normalize_seed(seed), 4])
    delta, k = float(mix["delta"]), int(mix["k"])
    answers = []
    for j in range(requests):
        sources = rng.integers(0, n, per).astype(np.int32)
        m1, m2 = sampled_moments(n, src, dst, w, sources,
                                 dtype=torch.bfloat16, device=dev)
        lam = m1 * (n / per)
        top = top_k(lam, k)
        hw = halfwidths(n, m1, m2, per, delta)[top] * n * max(n - 2, 1)
        answers.append(Answer(
            rid=j, eps=float(mix["eps_mix"][j % len(mix["eps_mix"])]),
            delta=delta, topk=top, lam=lam[top], halfwidth=hw,
            n_samples=per, n_epochs=1, converged=False, cap=per,
            sources=sources))
    checks, _ = check_answers(arcs, answers, check["limits"], device=device)
    return {name: (v, lim) for name, v, lim in checks}


def main() -> None:
    for p in (os.path.join(ROOT, "src"), ROOT):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.harness import graphs
    from portbench.harness.spec import load_cell

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    cell = load_cell(a.workload)
    arcs = graphs.load(cell.config, cell.root)
    for seed in a.seeds:
        t0 = time.perf_counter()
        r = reading(arcs, cell.workload["check"], cell.traffic, seed,
                    a.device)
        fails = [name for name, (v, lim) in r.items() if not v <= lim]
        print(f"[control] {a.workload} seed {seed}: bfloat16 reference "
              + ", ".join(f"{name} {v!r} (limit {lim!r})"
                          for name, (v, lim) in r.items())
              + f"; {'fails ' + ', '.join(fails) if fails else 'PASSES'} "
              f"{time.perf_counter() - t0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
