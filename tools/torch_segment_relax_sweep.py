#!/usr/bin/env python3
"""Time the sparse-relax kernel over its long-run threshold on the card.

    python3 tools/torch_segment_relax_sweep.py [--scale 18]
        [--thresholds 32,64,128,256,512,1024,4096,1000000000]

Needs one CUDA card. Builds ``chip_smoke.py``'s weighted R-MAT graph at
``--scale``, plans its unpinned (ε, δ) query, runs the first sample batch's
MFBF sweep for its distances and takes ``chip_smoke.relax_shapes``: the
full-edge-list MFBF relax and a bucket-2 MFBr relax. For each shape and
threshold (runs longer than it take a block each): the long runs' count
and share of the live arcs, the kernel's time (CUDA events, 20 calls after
a warm-up) and its share of ``chip_smoke.relax_bound``. The wrapper's
default is ``repro_torch.kernels.segment_relax.LONG_RUN``. Then, at the
default, the shape's longest run alone (every other run emptied) and the
shape without it: what the one block of the longest run costs against the
rest of the call.
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402  (exits without a CUDA card)
from repro_torch.bc import BCQuery, build_executor, plan  # noqa: E402
from repro_torch.core.monoids import Runs  # noqa: E402
from repro_torch.core.mfbf import mfbf  # noqa: E402
from repro_torch.kernels.segment_relax import (LONG_RUN,  # noqa: E402
                                               segment_relax_cuda)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--thresholds",
                    default="32,64,128,256,512,1024,4096,1000000000")
    args = ap.parse_args(argv)
    thresholds = [int(t) for t in args.thresholds.split(",")]
    g = cs.graph(args.scale)
    q = BCQuery(mode="approx", eps=0.05, delta=0.1, topk=10)
    ex = build_executor(g, plan(g, q, device=cs.DEV), device=cs.DEV)
    src = torch.arange(ex.n_b, device=cs.DEV)
    Tw, Tm = mfbf(ex._adj, src)
    print(f"[sweep] rmat scale {args.scale}: n={g.n} m={g.m}; default "
          f"threshold {LONG_RUN}; {torch.cuda.get_device_name(0)}")
    for name, (kind, fw, f2, runs) in cs.relax_shapes(ex, Tw, Tm).items():
        nb, n = fw.shape
        lens = runs.offsets[1:] - runs.offsets[:-1]
        arcs = int(runs.offsets[-1])
        b_ms, b_by, _ = cs.relax_bound(runs, nb, n, 2 if kind == "mp" else 3)
        op = (fw, f2, runs.col, runs.w, runs.offsets)
        print(f"[sweep] {name}: ({nb}, {n}), {arcs} live arcs, longest run "
              f"{int(lens.max())}, bound {b_ms:.4f} ms ({b_by})")
        for t in thresholds:
            long = lens > t
            ms = cs.time_ms(lambda: segment_relax_cuda(
                *op, centpath=kind == "cp", threshold=t), iters=20)
            print(f"[sweep]   threshold {t:>10d}: {int(long.sum()):7d} long "
                  f"runs, {float(lens[long].sum()) / max(arcs, 1):6.1%} of "
                  f"the arcs; {ms:.4f} ms, {100 * b_ms / ms:.1f}% of bound")
        for what, r in split_longest(runs).items():
            ms = cs.time_ms(lambda: segment_relax_cuda(
                fw, f2, r.col, r.w, r.offsets, centpath=kind == "cp"),
                iters=20)
            print(f"[sweep]   {what} ({int(r.offsets[-1])} arcs): {ms:.4f} ms")


def split_longest(runs: Runs) -> dict:
    """The runs with only the longest one kept, and with it emptied."""
    off = runs.offsets
    v = int((off[1:] - off[:-1]).argmax())
    lo, hi = int(off[v]), int(off[v + 1])
    alone = torch.zeros_like(off)
    alone[v + 1:] = hi - lo
    keep = torch.ones(runs.col.shape[0], dtype=torch.bool, device=off.device)
    keep[lo:hi] = False
    rest = off.clone()
    rest[v + 1:] -= hi - lo
    return {
        f"the longest run alone (run {v})": Runs(
            runs.col[lo:hi].contiguous(), None, runs.w[lo:hi].contiguous(),
            alone),
        "all but the longest run": Runs(runs.col[keep].contiguous(), None,
                                        runs.w[keep].contiguous(), rest)}


if __name__ == "__main__":
    main()
