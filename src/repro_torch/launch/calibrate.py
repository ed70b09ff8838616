"""Measure batch-step times on one device and fit the α-β step rates.

A port of ``repro/launch/calibrate.py``. The planner's analytic regime
model (``spgemm.autotune.choose_bc_regime``) prices the reference's TPU
target from first-principles constants; this module measures the device
the port actually runs on:

1. build one executor per variant (dense / COO / CSR) on an R-MAT
   calibration graph, through the same ``BCPlanner`` → ``build_executor``
   path a query takes;
2. time warm ``step`` calls at two batch sizes (best of ``reps``, after a
   warm-up call that builds the kernels and grows the allocator);
3. fit ``t(n_b) = α + W(n_b)/rate`` per variant, where
   ``W(n_b) = 2·est_iters·relax_ops(backend, n, m, n_b)`` is the planner's
   own priced work for one batch, so the iteration heuristic's error
   cancels when a plan multiplies it back in;
4. write a ``spgemm.cost_model.Calibration`` to the port's own file,
   ``DEFAULT_CALIBRATION_PATH`` (``results/cost_calibration_torch.json``)
   or ``$REPRO_TORCH_BC_CALIBRATION`` or ``--out``. The reference's file is
   never read or written.

Which key holds the dense time: on the card the port's dense relaxes
always run the Hopper product kernels (on the CPU, their plain versions),
so there is one dense route, and its time is written under ``"dense"``,
the key ``choose_bc_regime`` reads to price the dense regime against COO
and CSR. No ``"dense_kernel"`` key is written: it would time the same
code, and the plan's ``use_kernel`` flag is recorded only.

Usage::

    PYTHONPATH=src python -m repro_torch.launch.calibrate \\
        --scale 10 --avg-degree 16 --nb 16,64 --reps 2 [--device cpu] \\
        [--out results/cost_calibration_torch.json]
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.bc.config import ExecutionConfig
from repro_torch.bc.executor import build_executor
from repro_torch.bc.planner import BCPlanner
from repro_torch.bc.query import BCQuery
from repro_torch.graphs.generators import rmat
from repro_torch.spgemm.cost_model import (Calibration, StepRates, relax_ops,
                                           save_calibration)

#: Backends calibrated by default, each under its own ``variant_key``.
DEFAULT_VARIANTS: Tuple[str, ...] = ("dense", "coo", "csr")


def _measure_step_seconds(g, backend: str, nb: int, reps: int,
                          device) -> float:
    """Warm wall-clock seconds of one padded ``step`` call (best of reps);
    ``step`` returns host arrays, so each call ends in a device sync."""
    q = BCQuery(mode="approx", n_b=nb,
                execution=ExecutionConfig(backend=backend,
                                          placement="single_host"))
    plan = BCPlanner(calibration=None).plan(g, q, n_devices=1)
    ex = build_executor(g, plan, device=device)
    rng = np.random.default_rng(0)
    src = rng.integers(0, g.n, size=nb).astype(np.int32)
    valid = np.ones(nb, bool)
    ex.step(src, valid)  # builds the kernels, warms the caches
    best = float("inf")
    for _ in range(max(reps, 1)):
        t0 = time.perf_counter()
        ex.step(src, valid)
        best = min(best, time.perf_counter() - t0)
    return best


def _fit_rates(backend: str, n: int, m: int, est_iters: int,
               t_by_nb: Dict[int, float]) -> StepRates:
    """Fit (rate, overhead) from measured batch times at two sizes.

    Two points on ``t(n_b) = α + W(n_b)/rate``: the slope over the priced
    work gives the throughput, the intercept (clamped ≥ 0: a negative
    intercept is measurement noise) the fixed per-call α. Degenerate
    measurements (non-increasing time) fall back to a pure throughput fit
    through the larger point.
    """
    (nb1, t1), (nb2, t2) = sorted(t_by_nb.items())[:2]
    w1 = 2.0 * est_iters * relax_ops(backend, n, m, nb1, est_iters=est_iters)
    w2 = 2.0 * est_iters * relax_ops(backend, n, m, nb2, est_iters=est_iters)
    if t2 > t1 > 0 and w2 > w1:
        rate = (w2 - w1) / (t2 - t1)
        overhead = max(0.0, t1 - w1 / rate)
    else:
        rate = w2 / max(t2, 1e-9)
        overhead = 0.0
    return StepRates(ops_per_s=rate, overhead_s=overhead)


def calibrate(g, *, nb_pair: Tuple[int, int] = (16, 64), reps: int = 2,
              variants: Sequence[str] = DEFAULT_VARIANTS,
              verbose: bool = False, device="cuda") -> Calibration:
    """Measure ``variants`` on graph ``g`` on ``device`` and fit a
    ``Calibration``."""
    dev = resolve_device(device)
    est_iters = BCPlanner._est_iters(g.n, weighted=bool(np.any(g.w != 1.0)),
                                     iters=0)
    rates: Dict[str, StepRates] = {}
    measured: Dict[str, Dict[int, float]] = {}
    for backend in variants:
        t_by_nb: Dict[int, float] = {}
        for nb in sorted(set(nb_pair)):
            t_by_nb[nb] = _measure_step_seconds(g, backend, nb, reps, dev)
            if verbose:
                print(f"[calibrate] {backend} n_b={nb}: {t_by_nb[nb]:.4f}s")
        measured[backend] = t_by_nb
        if len(t_by_nb) == 1:  # degenerate pair: pure throughput fit
            (nb,) = t_by_nb
            t_by_nb = {0: 0.0, nb: t_by_nb[nb]}
        rates[backend] = _fit_rates(backend, g.n, g.m, est_iters, t_by_nb)
    return Calibration(
        rates=rates,
        meta={
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                       else "cpu"),
            "torch": torch.__version__,
            "graph": {"n": int(g.n), "m": int(g.m)},
            "n_b": sorted(set(nb_pair)),
            "est_iters": int(est_iters),
            "reps": int(reps),
            "measured_step_s": {k: {str(nb): t for nb, t in v.items()}
                                for k, v in measured.items()},
            "measured_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime()),
        })


def main(argv: Optional[Sequence[str]] = None) -> Calibration:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scale", type=int, default=10,
                    help="R-MAT scale of the calibration graph")
    ap.add_argument("--avg-degree", type=int, default=16)
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--nb", default="16,64",
                    help="comma-separated batch-size pair to fit over")
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--out", default=None,
                    help="output path (default "
                         "results/cost_calibration_torch.json or "
                         "$REPRO_TORCH_BC_CALIBRATION)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[calibrate] {e}")

    g = rmat(args.scale, args.avg_degree, seed=args.seed)
    nb_pair = tuple(int(x) for x in args.nb.split(","))
    cal = calibrate(g, nb_pair=nb_pair, reps=args.reps, verbose=True,
                    device=args.device)
    path = save_calibration(cal, args.out)
    print(f"[calibrate] wrote {path}")
    for key, r in sorted(cal.rates.items()):
        print(f"[calibrate]   {key}: {r.ops_per_s:.3e} ops/s "
              f"(+{r.overhead_s * 1e3:.2f} ms/call)")
    return cal


if __name__ == "__main__":
    main()
