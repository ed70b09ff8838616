#!/usr/bin/env python3
"""Where a batch of the sparse (CSR) path spends its time on the card.

    python3 tools/torch_sparse_profile.py [--scale 18] [--batches 3] [--trace]

Needs one CUDA card. Builds the weighted R-MAT graph that ``chip_smoke.py``
drives (edge factor 16, weights in [1, 100], isolated vertices removed,
seed 0) at ``--scale``, plans phase 6d's unpinned query (ε = 0.05,
δ = 0.1, top-10), builds its executor and, after one warm-up batch, runs
the query's first sample batch ``--batches`` times through ``step``:

* the host clock per batch;
* a breakdown by call: each CSR relax (MFBF or MFBr, by capacity bucket or
  the full-edge-list fallback) and the SP-DAG child count, each timed
  between two ``torch.cuda.synchronize()`` (the sweeps already sync once
  per iteration, so this adds one sync per relax); what is left of the
  batch is the sweeps' own elementwise steps, the bucket-pick reads and
  the host loop;
* with ``--trace``, ``torch.profiler`` over one more batch: the device's
  busy share (kernel time over the batch's wall time) and the kernels
  with the most device time. Where the profiler records no device time it
  prints "not measured". The sparse-relax kernel's share is summed over
  its prep and relax launches.
"""
from __future__ import annotations

import argparse
import collections
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro_torch.approx.sampling import AdaptiveSampler  # noqa: E402
from repro_torch.bc import BCQuery, build_executor, plan  # noqa: E402
from repro_torch.graphs.generators import rmat  # noqa: E402

DEV = torch.device("cuda")


class TimedCsr:
    """A ``CsrAdj`` whose relaxes and child count are timed per call."""

    def __init__(self, adj):
        self.adj = adj
        self.acc = collections.defaultdict(lambda: [0, 0.0, 0])

    def __getattr__(self, name):
        return getattr(self.adj, name)

    def _timed(self, sweep, fn, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, st = fn(*args)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        where = ("fallback" if st.overflow else
                 f"bucket {st.bucket} (ecap {self.adj.caps[st.bucket][1]})")
        rec = self.acc[f"{sweep} {where}"]
        rec[0] += 1
        rec[1] += dt
        rec[2] += st.arcs
        return out, st

    def relax_mp_stats(self, F, counts=None):
        return self._timed("MFBF relax", self.adj.relax_mp_stats, F, counts)

    def relax_cp_stats(self, F, counts=None):
        return self._timed("MFBr relax", self.adj.relax_cp_stats, F, counts)

    def count_sp_children(self, Tw):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = self.adj.count_sp_children(Tw)
        torch.cuda.synchronize()
        rec = self.acc["child count (COO, full edge list)"]
        rec[0] += 1
        rec[1] += time.perf_counter() - t0
        rec[2] += self.adj.src.shape[0]
        return out


def profile_batch(ex, src, valid) -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        ex.step(src, valid)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.key_averages()
               if getattr(e, "device_type", None) == DeviceType.CUDA]

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0.0))

    total_us = sum(dev_us(e) for e in kernels)
    if total_us <= 0:
        print("[profile] torch.profiler: device time not measured (no "
              "kernel events recorded)")
        return
    print(f"[profile] torch.profiler, one batch: wall {wall * 1e3:.3f} ms, "
          f"kernel time {total_us / 1e3:.3f} ms, device busy share "
          f"{total_us / 1e6 / wall:.4f}, {sum(e.count for e in kernels)} "
          "kernel launches")
    for e in sorted(kernels, key=dev_us, reverse=True)[:12]:
        print(f"[profile]   {dev_us(e) / 1e3:10.3f} ms {e.count:6d}x  "
              f"{e.key[:100]}")
    # the sparse-relax kernel's two launches per call (its prep pass and
    # the relax) carry the source's name in their mangled symbols
    relax = [e for e in kernels if "segment_relax" in e.key]
    relax_us = sum(dev_us(e) for e in relax)
    print(f"[profile] segment_relax (prep + relax): {relax_us / 1e3:.3f} ms "
          f"in {sum(e.count for e in relax)} launches, "
          f"{100 * relax_us / total_us:.1f} % of the kernel time")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=18)
    ap.add_argument("--batches", type=int, default=3)
    ap.add_argument("--trace", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_sparse_profile: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[profile] nvidia-smi: {smi}")
    g, _ = rmat(args.scale, 16, seed=0, weighted=True, max_weight=100
                ).remove_isolated()
    q = BCQuery(mode="approx", eps=0.05, delta=0.1, topk=10)
    pl = plan(g, q, device=DEV)
    ex = build_executor(g, pl, device=DEV)
    print(f"[profile] rmat scale {args.scale}: n={g.n} m={g.m}; "
          f"{pl.summary()}; caps {ex._adj.caps}")
    sampler = AdaptiveSampler(g.n, eps=q.eps, delta=q.delta, n_b=ex.n_b,
                              seed=q.seed)
    _, tau0 = sampler.next_epoch()
    src = sampler.draw(min(tau0, ex.n_b)).astype(np.int32)
    valid = np.ones(src.size, bool)
    ex.step(src, valid)  # warm-up
    torch.cuda.synchronize()
    walls = []
    for _ in range(args.batches):
        t0 = time.perf_counter()
        ex.step(src, valid)
        walls.append(time.perf_counter() - t0)
    print(f"[profile] one batch ({src.size} sources): "
          f"{', '.join(f'{w:.4f}' for w in walls)} s")
    timed = TimedCsr(ex._adj)
    ex._adj = timed
    t0 = time.perf_counter()
    for _ in range(args.batches):
        ex.step(src, valid)
    wall = (time.perf_counter() - t0) / args.batches
    ex._adj = timed.adj
    accounted = 0.0
    print(f"[profile] by call, per batch (synchronised; batch {wall:.4f} s):")
    for key, (calls, secs, arcs) in sorted(timed.acc.items(),
                                           key=lambda kv: -kv[1][1]):
        per = secs / args.batches
        accounted += per
        print(f"[profile]   {key:44s} {calls / args.batches:6.1f} calls "
              f"{per * 1e3:10.3f} ms ({100 * per / wall:5.1f} %), "
              f"{secs / calls * 1e3:8.3f} ms a call, "
              f"{arcs / max(calls, 1):12.0f} arcs a call")
    rest = wall - accounted
    print(f"[profile]   {'rest (sweep steps, reads, host loop)':44s} "
          f"{'':12s}{rest * 1e3:10.3f} ms ({100 * rest / wall:5.1f} %)")
    if args.trace:
        profile_batch(ex, src, valid)


if __name__ == "__main__":
    main()
