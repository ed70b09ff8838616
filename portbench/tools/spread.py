#!/usr/bin/env python3
"""Run one cell several times in a row and print the spread of its metrics.

    python3 portbench/tools/spread.py --workload er64k.dense \\
        --seeds 11 12 13 14 15 16 --seconds 40 [--trace 1] [--out DIR]

Each run is ``portbench/run.py`` in a process of its own, one after the
other, from the root of the checkout. Each run's standard error goes to
``<out>/<workload>-<seed>-t<trace>-<i>.log`` and its result line to
``<out>/<workload>.jsonl``. Last it prints, for every metric, the median,
the quartiles (``statistics.quantiles(values, n=4)``) and the spread: the
distance between the quartiles as a share of the median.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spread(values):
    """(median, q1, q3, (q3 - q1) / median) of ``values``."""
    med = statistics.median(values)
    if len(values) < 2:
        return med, med, med, 0.0
    q1, _, q3 = statistics.quantiles(values, n=4)
    return med, q1, q3, (q3 - q1) / abs(med) if med else float("inf")


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, default=0)
    ap.add_argument("--out", default="chiprun_out/portbench")
    a = ap.parse_args()
    os.makedirs(os.path.join(ROOT, a.out), exist_ok=True)
    results = []
    for i, seed in enumerate(a.seeds):
        log = os.path.join(ROOT, a.out,
                           f"{a.workload}-{seed}-t{a.trace}-{i}.log")
        t0 = time.perf_counter()
        with open(log, "w") as err:
            p = subprocess.run(
                [sys.executable, "portbench/run.py", "--workload",
                 a.workload, "--seed", str(seed), "--seconds",
                 str(a.seconds), "--trace", str(a.trace)],
                cwd=ROOT, stdout=subprocess.PIPE, stderr=err, text=True)
        wall = time.perf_counter() - t0
        last = p.stdout.strip().splitlines()[-1] if p.stdout.strip() else ""
        print(f"[spread] {a.workload} seed {seed} rc {p.returncode} "
              f"{wall:.1f}s: {last}", flush=True)
        if p.returncode == 0 and last:
            res = json.loads(last)
            res["seed"], res["wall_s"] = seed, wall
            results.append(res)
            with open(os.path.join(ROOT, a.out, f"{a.workload}.jsonl"),
                      "a") as f:
                f.write(json.dumps(res) + "\n")
    names = sorted({k for r in results for k in r["metrics"]})
    for name in names:
        vals = [r["metrics"][name]["value"] for r in results
                if name in r["metrics"]]
        med, q1, q3, sp = spread(vals)
        print(f"[spread] {a.workload} {name}: n {len(vals)} median "
              f"{med!r} q1 {q1!r} q3 {q3!r} spread {sp:.6f} values "
              f"{vals}", flush=True)
    bad = [r["seed"] for r in results if not r["correct"]]
    print(f"[spread] {a.workload}: {len(results)}/{len(a.seeds)} ran, "
          f"incorrect seeds {bad}", flush=True)


if __name__ == "__main__":
    main()
