"""Exact sweeps: the throughput of ``repro_torch.bc.solve.solve`` sweeping
sources, the paper's TEPS.

The mix (``traffic/<name>.json``) gives:

* ``backend``: the pinned ``ExecutionConfig`` backend, or null for the
  planner's own;
* ``n_b``: the pinned batch: a number, ``"batch"`` for the
  configuration's ``batch``, or null for the planner's;
* ``trace_seconds``: how long the window of a traced run lasts, where
  tracing all of ``seconds`` would take longer to read than a run may
  (null: all of it).

Set-up loads the configuration's graph (``harness.graphs``), plans with
``repro_torch.bc.solve.plan`` and builds the executor once with
``repro_torch.bc.executor.build_executor``; one batch runs before the
window, so that the only shapes warmed are the cell's own. The run's
seed draws a permutation of the vertices; the window's batches are its
consecutive ``n_b`` slices from the front, the warm-up's its last. The
window calls ``solve(g, BCQuery(mode="exact"), executor=ex,
sources=<batch>)`` back to back until ``seconds`` have passed. ``teps``
is the graph's arcs times the sources swept over the window's seconds,
from the start of its first call to the end of its last; ``setup_s``
runs from the process's start to the window's.

Each call's answer is that batch's λ. A sample of the calls, drawn from
the seed, is held after the window against the plain reference
(``reference/brandes.py``), on the card, once the program's state is
freed.
"""
from __future__ import annotations

import time
from typing import Dict, List, Optional, Tuple

import numpy as np

from portbench.harness import graphs, trace
from portbench.harness.device import log
from portbench.harness.result import (LayerContext, Record, Reservoir,
                                      lam_rel_err)
from portbench.harness.spec import Cell

KERNELS = ("multpath_mm", "centpath_mm", "segment_relax")


class Sources:
    """The sources of each call, from a permutation of the vertices that
    the run's seed draws: the window's i-th batch, and the warm-up's."""

    def __init__(self, n: int, nb: int, seed: int):
        self.perm = np.random.default_rng(
            [graphs.normalize_seed(seed), 1]).permutation(n).astype(np.int32)
        self.nb = nb

    def window(self, i: int) -> np.ndarray:
        """The i-th batch (wrapping round the permutation)."""
        return np.take(self.perm, np.arange(i * self.nb, (i + 1) * self.nb),
                       mode="wrap")

    def warm(self) -> np.ndarray:
        """From the far end of the permutation, away from the window's."""
        return self.window(-1)


def _launch_counters() -> Dict[str, int]:
    from repro_torch.kernels.centpath_mm import centpath_matmul_cuda
    from repro_torch.kernels.segment_relax import segment_relax_cuda
    from repro_torch.kernels.tropical_mm import multpath_matmul_cuda

    return {"multpath_mm": multpath_matmul_cuda.launches,
            "centpath_mm": centpath_matmul_cuda.launches,
            "segment_relax": segment_relax_cuda.launches}


def _batch_size(cell: Cell) -> Optional[int]:
    nb = cell.traffic.get("n_b")
    if nb == "batch":
        return int(cell.config["batch"])
    return None if nb is None else int(nb)


def query(cell: Cell):
    from repro_torch.bc import BCQuery, ExecutionConfig

    backend = cell.traffic.get("backend")
    return BCQuery(mode="exact", n_b=_batch_size(cell),
                   iters=int(cell.config.get("iters", 0)),
                   execution=None if backend is None
                   else ExecutionConfig(backend=backend))


def sweep(cell: Cell, *, seed: int, seconds: float, traced: bool,
          t_start: float, device: str) -> Dict:
    """Set-up and the window; the sampled answers and the graph for the
    check, and what the readers read."""
    import torch

    from repro_torch.bc import build_executor, plan, solve
    from repro_torch.graphs.formats import Graph

    cuda = device == "cuda"
    dev = torch.device("cuda", 0) if cuda else torch.device("cpu")
    if cuda:
        torch.cuda.set_device(dev)
    t_ready = time.perf_counter() - t_start  # imports, CUDA
    t0 = time.perf_counter()
    n, src, dst, w = graphs.load(cell.config, cell.root)
    g = Graph(n, src, dst, w, directed=False, name=cell.config_name)
    t_graph = time.perf_counter() - t0
    q = query(cell)
    t0 = time.perf_counter()
    pl = plan(g, q, n_devices=cell.chips, device=device)
    ex = build_executor(g, pl, device=device)
    t_build = time.perf_counter() - t0
    log(f"graph {cell.config_name}: n={n} arcs={g.m} ({t_graph:.3f}s); "
        f"plan: backend={pl.backend} n_b={pl.n_b} "
        f"buckets={tuple(pl.buckets)} block={pl.block} "
        f"placement={pl.placement} predicted {pl.predicted_seconds:.6g}s "
        f"for all n sources; executor n_b={ex.n_b} built in {t_build:.3f}s")

    pick = Sources(n, ex.n_b, seed)
    t0 = time.perf_counter()
    solve(g, q, executor=ex, sources=pick.warm())
    t_warm = time.perf_counter() - t0

    keep = Reservoir(int(cell.workload["check"]["batches"]),
                     graphs.normalize_seed(seed))
    before = _launch_counters()
    occ0 = dict(ex.occupancy_summary() or {}) if hasattr(
        ex, "occupancy_summary") else {}
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    setup_s = time.perf_counter() - t_start
    if traced and cell.traffic.get("trace_seconds"):
        seconds = min(seconds, float(cell.traffic["trace_seconds"]))
    batches = swept = 0
    times = []
    with trace.profiler(traced, dev.type) as prof:
        with trace.span("window"):
            w0 = time.perf_counter()
            while not batches or time.perf_counter() - w0 < seconds:
                sources = pick.window(batches)
                t0 = time.perf_counter()
                with trace.span("solve"):
                    res = solve(g, q, executor=ex, sources=sources)
                times.append(time.perf_counter() - t0)
                keep.offer((sources, res.lam))
                batches += 1
                swept += res.n_samples
            window_s = time.perf_counter() - w0
    after = _launch_counters()
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    occ1 = dict(ex.occupancy_summary() or {}) if hasattr(
        ex, "occupancy_summary") else {}
    dt = None
    if prof is not None:
        t0 = time.perf_counter()
        dt = trace.reduce(prof, dev.type)
        log(f"trace: {time.perf_counter() - w0 - window_s:.3f}s to stop "
            f"the profiler and read {len(dt.ops) if dt else 0} device "
            f"operations ({time.perf_counter() - t0:.3f}s reading)")
    log(f"set-up: imports and device {t_ready:.3f}s, graph {t_graph:.3f}s, "
        f"plan and executor {t_build:.3f}s, warm {t_warm:.3f}s; setup_s "
        f"{setup_s:.3f}")
    q1, q2, q3 = np.percentile(times, [25, 50, 75])
    log(f"window: {batches} calls in {window_s:.3f}s; seconds a call: "
        f"min {min(times):.6f} q1 {q1:.6f} median {q2:.6f} q3 {q3:.6f} "
        f"max {max(times):.6f}")
    occ = None
    if occ1.get("relax_calls") is not None:
        occ = {k: occ1[k] - occ0.get(k, 0)
               for k in ("compact_hits", "relax_calls", "overflows")}
    out = dict(
        batches=batches, swept=swept, window_s_host=window_s,
        setup_s=setup_s, arcs=g.m, graph=(n, src, dst, w),
        sample=keep.items, trace=dt,
        launches={k: after[k] - before[k] for k in KERNELS},
        product_shape=(ex.n_b, n, n) if pl.backend == "dense" else None,
        occupancy=occ, peak=max(setup_peak, window_peak),
        peak_window=window_peak)
    del ex, g
    if cuda:
        torch.cuda.empty_cache()
    return out


def _check(cell: Cell, r0: Dict, device: str) -> Tuple[List[Tuple[str, float,
                                                                   float]], int]:
    """The sampled answers against the reference: the worst error beside
    its limit, and how many answers lie over it."""
    import torch

    from portbench.reference.brandes import batch_lambda

    n, src, dst, w = r0["graph"]
    limit = float(cell.workload["check"]["limits"]["lam_rel_err"])
    dev = "cuda:0" if device == "cuda" else "cpu"
    errs = []
    t0 = time.perf_counter()
    for sources, lam in r0["sample"]:
        want = batch_lambda(n, src, dst, w, sources, dtype=torch.float64,
                            device=dev)
        errs.append(lam_rel_err(lam, want))
    log(f"check: {len(errs)} of {r0['batches']} answers against the "
        f"reference in {time.perf_counter() - t0:.3f}s")
    worst = max(errs, default=float("inf"))
    return [("lam_rel_err", worst, limit)], sum(not e <= limit for e in errs)


def run(cell: Cell, *, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda") -> Record:
    import torch

    r0 = sweep(cell, seed=seed, seconds=seconds, traced=traced,
               t_start=t_start, device=device)
    checks, failed = _check(cell, r0, device)
    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"),
                "count": 1, "memory_peak_bytes": int(r0["peak"])}
    dt = r0["trace"]
    if dt is not None:
        dev_info["busy_s"] = float(dt.busy_s)
        dev_info["window_s"] = float(dt.window_s)
    return Record(
        end_to_end={"teps": r0["arcs"] * r0["swept"] / r0["window_s_host"],
                    "setup_s": r0["setup_s"]},
        attempted=r0["batches"], failed=failed, checks=checks,
        device=dev_info,
        layers=LayerContext(
            batches=r0["batches"], trace=dt, launches=r0["launches"],
            product_shape=r0["product_shape"], occupancy=r0["occupancy"],
            peak_window_bytes=r0["peak_window"]))
