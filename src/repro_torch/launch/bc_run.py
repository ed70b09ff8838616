"""Exact betweenness-centrality launcher of the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.bc_run --graph rmat --scale 8 \
      --degree 8 --nb 64 [--weighted] [--iterate while|fori] \
      [--device cuda|cpu] [--verify]

Runs the paper's Algorithm 3 on the dense backend through
``repro_torch.core.mfbc.mfbc``: on the card by default, through the Hopper
kernels; ``--device cpu`` runs their plain PyTorch versions. ``--verify``
checks λ against the numpy Brandes oracle. The planner, ``--approx``,
``--mesh``, ``--metric`` and ``--ckpt-dir`` of ``repro.launch.bc_run`` are
not ported yet.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch import resolve_device
from repro_torch.core.brandes_ref import brandes_bc
from repro_torch.core.mfbc import mfbc
from repro_torch.graphs.generators import from_spec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat",
                    choices=["rmat", "uniform", "er"])
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--weighted", action="store_true")
    ap.add_argument("--nb", type=int, default=64, help="batch size")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--iterate", default="while", choices=["while", "fori"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--verify", action="store_true",
                    help="check against the Brandes oracle (slow)")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[bc] {e}")

    g = from_spec(args.graph, scale=args.scale, degree=args.degree,
                  weighted=args.weighted, seed=args.seed)
    g, _ = g.remove_isolated()
    print(f"[bc] graph {g.name}: n={g.n} m={g.m} device={args.device}")
    n_b = min(args.nb, g.n)
    total_batches = -(-g.n // n_b)

    def progress(b, n_batches, lam):
        print(f"[bc] batch {b + 1}/{total_batches}")

    t0 = time.time()
    lam = mfbc(g, n_b=n_b, iterate=args.iterate, device=args.device,
               progress_cb=progress)
    dt = time.time() - t0
    # TEPS as the paper counts it: every edge is traversed once per source
    teps = g.m * g.n / dt
    print(f"[bc] done in {dt:.2f}s — {teps:,.0f} TEPS (model)")
    top = np.argsort(lam)[::-1][:5]
    print("[bc] top-5 central vertices:", list(zip(top.tolist(),
                                                   np.round(lam[top], 2))))
    if args.verify:
        np.testing.assert_allclose(lam, brandes_bc(g), rtol=1e-4, atol=1e-6)
        print("[bc] verified against the Brandes oracle")
    return lam


if __name__ == "__main__":
    main()
