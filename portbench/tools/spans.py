#!/usr/bin/env python3
"""One traced run of a cell on the card with the program's spans laid
beside its trace.

    python3 portbench/tools/spans.py --workload rmat20.auto --seed 7

Times the off path of ``repro_torch.tracing`` first, then runs the cell as
``portbench/run.py --trace 1 --seconds <BENCHMARK.json's run_seconds>``
does, in this process, and prints that run's result line. The last line of
standard output is one more JSON object:

* ``off_ns``: what ``span`` (entered and left) and ``count`` cost a call
  with no profiler running, beside an empty loop's turn;
* ``spans``: ``tracing.summary`` of the window's spans, and its counters;
* ``accounting``: the ``batch`` spans' device seconds beside the trace's
  busy and window seconds; the child count and run building a call beside
  ``torch_ops_ms_per_batch``; ``host_syncs`` a call beside the relax calls
  a call + 3 (``occupancy_summary()`` on CSR, the product launches on
  dense); the idle seconds the trace names ``solve:python`` and those it
  names by a program span.
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))
from portbench import run  # noqa: E402  (its import: the process's start)

import argparse  # noqa: E402
import json  # noqa: E402
import time  # noqa: E402


def off_ns(n: int = 200_000) -> dict:
    """ns a call of the off path: ``span`` entered and left, ``count``."""
    import torch

    from repro_torch import tracing

    device = torch.device("cuda", 0)

    def loop(body):
        t0 = time.perf_counter_ns()
        body(n)
        return (time.perf_counter_ns() - t0) / n

    def empty(k):
        for _ in range(k):
            pass

    def spans(k):
        for _ in range(k):
            with tracing.span("batch", device, rows=16, n=1):
                pass

    def counts(k):
        for _ in range(k):
            tracing.count("host_syncs")

    return {"loop": loop(empty), "span": loop(spans),
            "count": loop(counts)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    a = ap.parse_args()
    with open(os.path.join(run.ROOT, "BENCHMARK.json")) as f:
        seconds = json.load(f)["run_seconds"]
    sys.path.insert(0, os.path.join(run.ROOT, "src"))
    from portbench.harness import spec as S
    from repro_torch import tracing

    cost = off_ns()
    # the run's per-layer context, kept as the harness hands it to the
    # readers
    seen = {}
    read_metrics = S.read_metrics

    def keep(cell, ctx):
        seen["ctx"] = ctx
        return read_metrics(cell, ctx)

    S.read_metrics = keep
    rc = run.main(["--workload", a.workload, "--seed", str(a.seed),
                   "--seconds", str(seconds), "--trace", "1"])
    if rc or "ctx" not in seen:
        return rc or 1
    ctx = seen["ctx"]
    dt = ctx.trace
    snap = tracing.snapshot(clear=False)
    summ = tracing.summary(snap)

    def dev_ms(name):
        return (summ.get(name) or {}).get("device_ms") or 0.0

    relax = (ctx.occupancy["relax_calls"] if ctx.occupancy else
             ctx.launches["multpath_mm"] + ctx.launches["centpath_mm"])
    idle = dt.idle_by_host
    print(json.dumps({
        "workload": a.workload, "seed": a.seed, "off_ns": cost,
        "spans": summ, "counters": snap.counters,
        "accounting": {
            "batches": ctx.batches,
            "batch_device_s": dev_ms("batch") / 1e3,
            "busy_s": dt.busy_s, "window_s": dt.window_s,
            "child_count_plus_csr_runs_ms_per_batch":
                (dev_ms("child_count") + dev_ms("csr.runs")) / ctx.batches,
            "host_syncs_per_batch":
                snap.counters.get("host_syncs", 0) / ctx.batches,
            "relax_calls_per_batch_plus_3": relax / ctx.batches + 3,
            "idle_solve_python_s": idle.get("solve:python", 0.0),
            "idle_in_program_spans_s": sum(
                v for k, v in idle.items()
                if k.split(":", 1)[-1].startswith(tracing.PREFIX)),
        }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
