"""Exact sweeps on a mesh of cards: the throughput of
``repro_torch.bc.solve.solve`` when every rank of a mesh runs it on its
blocks of A and Aᵀ (the paper's Theorem 5.1 step), in TEPS.

The mix (``traffic/<name>.json``) gives what ``exact_sweep`` reads
(``backend``, ``n_b``, ``trace_seconds``) and ``mesh``: the axis sizes,
``"DxM"`` (data, model) or ``"PxDxM"`` (pod, data, model), pinned so that
no choice of the planner's can change the layout. The mesh has as many
ranks as the product of its sizes, each a process of its own on card r
(NCCL), or on the CPU over gloo with ``--device cpu``; the cell's
``chips`` must equal that product.

This process is no rank. It makes the graph's cache and builds the
kernels once, starts the ranks, waits for them and checks their answers.
Each rank loads the graph from the cache, builds the mesh and
``build_executor(g, plan(g, q, mesh=mesh), mesh=mesh)`` (a
``MeshExecutor``) and runs one warm batch, from the far end of the seed's
permutation (``exact_sweep.Sources``). After a barrier the ranks call
``solve(g, q, executor=ex, sources=<batch>)`` on its consecutive slices
from the front, back to back, each call started together: before each,
rank 0 says whether the window goes on, by a broadcast over a gloo group
of this module's own, off the cards. ``teps`` is the graph's arcs times
the sources swept over rank 0's window, from the barrier to the end of
its last call's λ on the host; ``setup_s`` runs from the process's start
to the barrier. A traced run profiles rank 0 alone, and its device trace,
spans and counters (``repro_torch.tracing``) come back for the readers.

After the window every rank frees its state, reports the modules it
loaded and exits. Then this process holds a sample of rank 0's answers,
drawn from the seed, against the plain reference on card 0
(``exact_sweep._check``). A rank that fails or exits non-zero, or a
mesh that gives no answer within ``RANK_TIMEOUT_S`` past the window's
seconds, ends the run with no result and a non-zero exit, every rank
stopped.
"""
from __future__ import annotations

import dataclasses
import datetime
import math
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Dict, Optional

import numpy as np

from portbench.drivers import exact_sweep
from portbench.harness import graphs, trace
from portbench.harness.device import forbidden_modules, log
from portbench.harness.result import LayerContext, Record, Reservoir
from portbench.harness.spec import Cell

RANK_TIMEOUT_S = 300  # set-up, the last call, the trace's reading, freeing
POLL_S = 1.0  # how often this process looks at the ranks


@dataclasses.dataclass
class MeshLayerContext(LayerContext):
    """What the readers read, from rank 0's traced window: the single
    card's fields, and rank 0's spans and counters."""

    snapshot: Optional[object] = None  # repro_torch.tracing.Snapshot


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _go(ctl, more: bool) -> bool:
    """Rank 0's ``more``, on every rank."""
    import torch
    import torch.distributed as dist

    flag = torch.tensor([int(more)])
    dist.broadcast(flag, src=0, group=ctl)
    return bool(flag.item())


def _sweep(rank: int, job: Dict, ctl, mesh) -> Dict:
    """One rank's set-up and window, and what it hands back."""
    import torch

    from repro_torch.bc import build_executor, plan, solve
    from repro_torch.graphs.formats import Graph

    cell: Cell = job["cell"]
    cuda = job["device"] == "cuda"
    dev = mesh.device
    t0 = time.perf_counter()
    n, src, dst, w = graphs.load(cell.config, cell.root)
    g = Graph(n, src, dst, w, directed=False, name=cell.config_name)
    q = exact_sweep.query(cell)
    pl = plan(g, q, mesh=mesh)
    ex = build_executor(g, pl, mesh=mesh)
    pick = exact_sweep.Sources(n, ex.n_b, job["seed"])
    solve(g, q, executor=ex, sources=pick.warm())
    t_ready = time.perf_counter() - t0
    if rank == 0:
        log(f"rank 0: graph {cell.config_name} n={n} arcs={g.m}; plan "
            f"backend={pl.backend} n_b={pl.n_b} mesh {mesh.axis_sizes} "
            f"over {mesh.backend}; executor n_b={ex.n_b}; graph, "
            f"executor, adjacency blocks and warm batch in {t_ready:.3f}s")
    keep = Reservoir(int(cell.workload["check"]["batches"]),
                     graphs.normalize_seed(job["seed"]))
    before = exact_sweep._launch_counters()
    bytes0 = dict(mesh.comm_bytes)
    setup_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    seconds = job["seconds"]
    if job["traced"] and cell.traffic.get("trace_seconds"):
        seconds = min(seconds, float(cell.traffic["trace_seconds"]))
    batches = swept = 0
    times = []
    with trace.profiler(job["traced"] and rank == 0, dev.type) as prof:
        import torch.distributed as dist

        dist.barrier(group=ctl)
        setup_s = time.time() - job["t0_wall"]
        with trace.span("window"):
            w0 = end = time.perf_counter()
            while _go(ctl, not batches or end - w0 < seconds):
                sources = pick.window(batches)
                t1 = time.perf_counter()
                with trace.span("solve"):
                    res = solve(g, q, executor=ex, sources=sources)
                end = time.perf_counter()
                times.append(end - t1)
                if rank == 0:
                    keep.offer((sources, res.lam))
                batches += 1
                swept += res.n_samples
    window_s = end - w0
    after = exact_sweep._launch_counters()
    window_peak = torch.cuda.max_memory_allocated(dev) if cuda else 0
    out = dict(batches=batches, peak=max(setup_peak, window_peak),
               peak_window=window_peak)
    if rank == 0:
        dt = snap = None
        if prof is not None:
            dt = trace.reduce(prof, dev.type)
            snap = _snapshot()
        q1, q2, q3 = np.percentile(times, [25, 50, 75])
        log(f"rank 0: setup_s {setup_s:.3f}; window: {batches} calls in "
            f"{window_s:.3f}s; seconds a call: min {min(times):.6f} q1 "
            f"{q1:.6f} median {q2:.6f} q3 {q3:.6f} max {max(times):.6f}")
        comm = {k: mesh.comm_bytes[k] - bytes0[k] for k in mesh.comm_bytes}
        log(f"rank 0: Mesh.comm_bytes in the window {comm}, a call "
            f"{sum(comm.values()) / batches:.6g} B; last batch's sweeps "
            f"(mp, cp, stop) {ex._context().sweeps}")
        if snap is not None:
            _log_spans(snap, batches)
        out.update(swept=swept, window_s=window_s, setup_s=setup_s,
                   arcs=g.m, sample=keep.items, trace=dt, snapshot=snap,
                   launches={k: after[k] - before[k]
                             for k in exact_sweep.KERNELS})
    del ex, g
    if cuda:
        torch.cuda.empty_cache()
    return out


def _snapshot():
    """The program's spans and counters of the traced window, or None where
    the program has no recorder."""
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot()


def _log_spans(snap, batches: int) -> None:
    from repro_torch import tracing

    for name, row in sorted(tracing.summary(snap).items()):
        log(f"rank 0: span {name}: {row['count']} ({row['count'] / batches:.3f}"
            f" a call), host ms {row['host_ms']:.3f}, device ms "
            f"{row['device_ms']}, self device ms {row['self_device_ms']}")
    log(f"rank 0: counters {dict(sorted(snap.counters.items()))}")


def _rank(rank: int, job: Dict, results) -> None:
    """One rank: its answer, or its traceback, on ``results``."""
    try:
        results.put((rank, _rank_main(rank, job)))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def _rank_main(rank: int, job: Dict) -> Dict:
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import Mesh

    cuda = job["device"] == "cuda"
    if cuda:
        os.environ["LOCAL_RANK"] = str(rank)  # the mesh's card: card r
        torch.cuda.set_device(rank)
    dist.init_process_group(
        "nccl" if cuda else "gloo",
        init_method=f"tcp://127.0.0.1:{job['port']}", rank=rank,
        world_size=job["world"],
        timeout=datetime.timedelta(seconds=RANK_TIMEOUT_S))
    ctl = dist.new_group(backend="gloo")
    mesh = Mesh(job["dims"], job["names"], device=job["device"])
    out = _sweep(rank, job, ctl, mesh)
    dist.barrier(group=ctl)  # every rank's state freed
    # (after a failure the process exits without this: a collective left
    # waiting on a rank that failed could hold it)
    dist.destroy_process_group()
    out["forbidden"] = forbidden_modules()
    return out


def _answers(procs, results, deadline: float) -> Dict[int, Dict]:
    """Every rank's answer; raises ``SystemExit`` when a rank failed or
    the deadline passed."""
    got: Dict[int, Dict] = {}
    while len(got) < len(procs):
        try:
            rank, out = results.get(timeout=POLL_S)
        except queue.Empty:
            for r, p in enumerate(procs):
                if r not in got and p.exitcode not in (None, 0):
                    raise SystemExit(f"portbench: rank {r} exited with "
                                     f"code {p.exitcode}")
            if time.monotonic() > deadline:
                raise SystemExit(f"portbench: the mesh gave no answer in "
                                 f"time ({sorted(got)} answered)")
            continue
        if isinstance(out, str):
            raise SystemExit(f"portbench: rank {rank} failed:\n{out}")
        got[rank] = out
    return got


def _run_ranks(job: Dict, world: int) -> Dict[int, Dict]:
    """Start the ranks and wait for them; each is joined, or killed on a
    failure, before this returns."""
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank, args=(r, job, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    ok = False
    try:
        got = _answers(procs, results,
                       time.monotonic() + job["seconds"] + RANK_TIMEOUT_S)
        ok = True
    finally:
        if not ok:
            log("the ranks at the failure: " + ", ".join(
                f"{r} {'running' if p.exitcode is None else p.exitcode}"
                for r, p in enumerate(procs)))
        for p in procs:
            if ok:
                p.join(timeout=RANK_TIMEOUT_S)
            if p.is_alive():
                p.kill()
            p.join()
    bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
    if bad:
        raise SystemExit(f"portbench: ranks {bad} exited non-zero")
    return got


def run(cell: Cell, *, seed: int, seconds: float, traced: bool,
        t_start: float, device: str = "cuda") -> Record:
    from repro_torch.launch.mesh import parse_mesh_spec

    dims, names = parse_mesh_spec(cell.traffic["mesh"])
    world = math.prod(dims)
    if world != cell.chips:
        raise SystemExit(f"portbench: mesh {cell.traffic['mesh']} has "
                         f"{world} ranks, the cell {cell.chips} chips")
    n, src, dst, w = graphs.load(cell.config, cell.root)  # the ranks' cache
    if device == "cuda":
        from repro_torch.kernels import _build

        _build.build_all()  # once, before the ranks load the kernels
    job = dict(cell=cell, seed=seed, seconds=seconds, traced=traced,
               device=device, dims=dims, names=names, world=world,
               port=_free_port(),
               t0_wall=time.time() - (time.perf_counter() - t_start))
    got = _run_ranks(job, world)
    for r, out in sorted(got.items()):
        if out["forbidden"]:
            raise SystemExit(f"portbench: rank {r} loaded "
                             f"{', '.join(out['forbidden'])}")
    r0 = got[0]
    r0["graph"] = (n, src, dst, w)
    checks, failed = exact_sweep._check(cell, r0, device)
    import torch

    dev_info = {"platform": "gpu" if device == "cuda" else "cpu",
                "kind": (torch.cuda.get_device_name(0) if device == "cuda"
                         else "cpu"),
                "count": world,
                "memory_peak_bytes": int(max(o["peak"]
                                             for o in got.values()))}
    dt = r0["trace"]
    if dt is not None:
        dev_info["busy_s"] = float(dt.busy_s)
        dev_info["window_s"] = float(dt.window_s)
    return Record(
        end_to_end={"teps": r0["arcs"] * r0["swept"] / r0["window_s"],
                    "setup_s": r0["setup_s"]},
        attempted=r0["batches"], failed=failed, checks=checks,
        device=dev_info,
        layers=MeshLayerContext(
            batches=r0["batches"], trace=dt, launches=r0["launches"],
            product_shape=None, occupancy=None,
            peak_window_bytes=int(max(o["peak_window"]
                                      for o in got.values())),
            snapshot=r0["snapshot"]))
