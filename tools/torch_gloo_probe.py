#!/usr/bin/env python3
"""Which collectives gloo runs on CUDA tensors, and how fast, on one card.

    python3 tools/torch_gloo_probe.py [--ranks 4]

Spawns ``--ranks`` processes that share cuda:0 in one gloo process group
(NCCL refuses two ranks on one card) and, on CUDA tensors: checks
``all_reduce`` MIN/MAX/SUM, ``all_gather`` (list form),
``all_gather_into_tensor``, ``reduce_scatter_tensor`` and a subgroup's
``all_reduce``; then times a 1.6 MB ``all_reduce`` MIN and ``all_gather``
(a (64, 6268) float32 block: one field of the (2, 2) mesh's frontier at
R-MAT scale 14) and a one-int ``all_reduce`` MAX (a sweep's stop test).
Last, one rank over NCCL runs the same checks. Prints the card's name and
power limit and one line per rank. Needs a card.
"""
from __future__ import annotations

import argparse
import socket
import subprocess
import sys
import time

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SHAPE = (64, 6268)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _timed(fn, iters: int) -> float:
    """Milliseconds a call, over ``iters`` calls after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / iters


def _rank(rank: int, world: int, port: int, backend: str, results) -> None:
    out = {}
    try:
        dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                                world_size=world, rank=rank)
        dev = torch.device("cuda", 0)
        torch.cuda.set_device(dev)
        x = torch.full((4,), float(rank), device=dev)
        checks = {
            "all_reduce min": lambda: dist.all_reduce(
                x.clone(), op=dist.ReduceOp.MIN),
            "all_reduce max": lambda: dist.all_reduce(
                x.clone(), op=dist.ReduceOp.MAX),
            "all_reduce sum": lambda: dist.all_reduce(x.clone()),
            "all_gather": lambda: dist.all_gather(
                [torch.empty_like(x) for _ in range(world)], x),
            "all_gather_into_tensor": lambda: dist.all_gather_into_tensor(
                torch.empty(4 * world, device=dev), x),
            "reduce_scatter_tensor": lambda: dist.reduce_scatter_tensor(
                torch.empty(1, device=dev), torch.ones(world, device=dev)),
        }
        for name, fn in checks.items():
            try:
                fn()
                out[name] = "ok"
            except (RuntimeError, ValueError) as e:
                out[name] = f"refused: {str(e).splitlines()[0][:120]}"
        group = dist.new_group(list(range(min(2, world))))
        if rank < 2:
            y = x.clone()
            dist.all_reduce(y, group=group)
            out["subgroup all_reduce"] = y[0].item()
        big = torch.rand(SHAPE, device=dev)
        parts = [torch.empty_like(big) for _ in range(world)]
        flag = torch.zeros(1, dtype=torch.int32, device=dev)
        out["all_reduce 1.6 MB ms"] = _timed(
            lambda: dist.all_reduce(big, op=dist.ReduceOp.MIN), 10)
        out["all_gather 1.6 MB ms"] = _timed(
            lambda: dist.all_gather(parts, big), 10)
        out["one-int all_reduce ms"] = _timed(
            lambda: dist.all_reduce(flag, op=dist.ReduceOp.MAX), 50)
        dist.destroy_process_group()
    except BaseException as e:  # report, then let the process fail
        out["failed"] = repr(e)[:400]
        results.put((rank, out))
        raise
    results.put((rank, out))


def run(world: int, backend: str) -> bool:
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank, args=(r, world, port, backend,
                                             results))
             for r in range(world)]
    for p in procs:
        p.start()
    got = dict(results.get(timeout=300) for _ in procs)
    for p in procs:
        p.join(60)
        if p.is_alive():
            p.kill()
    for r in sorted(got):
        print(f"{backend} rank {r}/{world}: {got[r]}", flush=True)
    return not any("failed" in v for v in got.values())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--ranks", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_gloo_probe: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"nvidia-smi: {smi}; torch {torch.__version__}", flush=True)
    ok = run(args.ranks, "gloo") and run(1, "nccl")
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
