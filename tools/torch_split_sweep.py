#!/usr/bin/env python3
"""Time both Hopper kernels of ``repro_torch`` over split counts.

    PYTHONPATH=src python3 tools/torch_split_sweep.py \\
        [--shape 64,3342,3342] [--splits 1,2,3,4,5,6,7,8,10,12,14,16]

Needs one CUDA card. For each kernel, at the shape (nb, n, n2), on random
inputs with half the frontier inactive and 30 % of the adjacency present,
launches the kernel with each split count S (through
``multpath_launch`` / ``centpath_launch``, so the launch counters do not
move) and prints the time per call from CUDA events over 50 calls after
3 warm-up calls, the number of blocks, and which S ``pick_splits``
chooses on this card. Each S's outputs are held against S = 1: ``w``
and ``c`` bitwise, ``m``/``p`` within rtol 1e-5.
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.kernels.centpath_mm import centpath_launch  # noqa: E402
from repro_torch.kernels.tropical_mm import (BM, BN, BK,  # noqa: E402
                                             multpath_launch, pick_splits,
                                             sm_count)

INF = float("inf")


def time_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--shape", default="64,3342,3342")
    ap.add_argument("--splits", default="1,2,3,4,5,6,7,8,10,12,14,16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_split_sweep: no CUDA device is available")
    nb, n, n2 = (int(x) for x in args.shape.split(","))
    dev = torch.device("cuda")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    sms = sm_count(0)
    pick = pick_splits(nb, n, n2, sms)
    tiles = -(-nb // BM) * -(-n2 // BN)
    print(f"[sweep] {smi}, {sms} SMs, shape {(nb, n, n2)}, {tiles} tiles, "
          f"{-(-n // BK)} k-tiles, pick_splits {pick}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    adj = torch.where(torch.rand((n, n2), generator=gen, device=dev) < 0.3,
                      torch.randint(1, 10, (n, n2), generator=gen,
                                    device=dev).float(), INF)
    active = torch.rand((nb, n), generator=gen, device=dev) < 0.5
    w = torch.randint(0, 20, (nb, n), generator=gen, device=dev).float()
    f2 = torch.rand((nb, n), generator=gen, device=dev)
    cases = {
        "multpath_mm": (multpath_launch, torch.where(active, w, INF),
                        torch.where(active, f2, 0.0), ("w", "m")),
        "centpath_mm": (centpath_launch, torch.where(active, w, -INF),
                        torch.where(active, f2, 0.0), ("w", "p", "c")),
    }
    splits = sorted({int(s) for s in args.splits.split(",")} | {1, pick})
    for name, (launch, fw, fx, fields) in cases.items():
        base = launch(fw, fx, adj, 1)
        for s in splits:
            got = launch(fw, fx, adj, s)
            torch.cuda.synchronize()
            for field, x, y in zip(fields, got, base):
                if field in ("w", "c"):
                    assert torch.equal(x, y), (name, s, field)
                else:
                    torch.testing.assert_close(x, y, rtol=1e-5, atol=0.0)
            ms = time_ms(lambda: launch(fw, fx, adj, s))
            mark = "  <- pick_splits" if s == pick else ""
            print(f"[sweep] {name} S={s:3d} blocks={tiles * s:5d} "
                  f"{ms:.4f} ms{mark}", flush=True)


if __name__ == "__main__":
    main()
