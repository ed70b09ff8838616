"""Betweenness-centrality launcher of the PyTorch port.

  PYTHONPATH=src python -m repro_torch.launch.bc_run --graph rmat \
      --scale 8 --degree 8 [--weighted] [--nb 64] \
      [--backend auto|dense|coo|csr] [--device cuda|cpu] [--verify] \
      [--metric betweenness|closeness|khop|components] [--hops k] \
      [--ckpt-dir d]

Every mode is one call into ``repro_torch.bc``: build a ``BCQuery``, let
``BCPlanner`` resolve the backend and batch size (printed as the ``BCPlan``
line; pin them with ``--backend`` and ``--nb``, 0 = the planner's pick)
and run ``solve`` on one device: the card by default, through the Hopper
kernels; ``--device cpu`` runs their plain PyTorch versions. ``--backend``
defaults to ``auto``, the planner's regime choice (CSR on R-MAT); a CSR
run also prints its frontier-occupancy summary.

Approximate mode (adaptive source sampling, ``repro_torch.approx``):

  PYTHONPATH=src python -m repro_torch.launch.bc_run --graph rmat \
      --scale 10 --approx 0.05,0.1 [--topk 10] \
      [--strategy adaptive|uniform] [--rule bernstein|normal] \
      [--max-samples N]

``--approx eps,delta`` replaces the exact all-sources sweep with the
epoch-doubling sampler and prints the top-k vertices with their
confidence intervals. ``--verify`` checks λ (exact) or the ε bound and
top-k precision (approx) against the numpy Brandes oracle.

``--metric`` swaps the analytic the sweep computes (the MetricSpec
registry, ``repro_torch.core.metrics``): closeness is the forward-only
farness profile, ``khop`` (with ``--hops k``) hop-bounded reachability,
and ``components`` the min-label fixed point (exact mode only, no source
sweep). ``--verify`` checks each against its own host oracle
(``closeness_ref``, ``khop_ref``, ``cc_ref``); in approximate mode, for a
metric other than betweenness, the top-k precision only.

``--mesh DxM|PxDxM`` pins placement to the distributed Theorem 5.1
moments step on a (data, model) or (pod, data, model) mesh of
``torch.distributed`` ranks; as in the reference it requires ``--approx``.
Every rank of a ``torchrun`` job runs the command, and rank 0 prints; the
axis-size product must equal the number of ranks. ``--dist-backend
nccl|gloo`` names the process group's backend (no default): NCCL for one
card a rank, gloo for ranks that share a card or run on the CPU::

  torchrun --nproc-per-node 4 -m repro_torch.launch.bc_run --mesh 2x2 \
      --approx 0.1,0.1 --dist-backend gloo --device cpu

Per-batch checkpointing (``--ckpt-dir``, exact mode): the cumulative λ,
the global batch index and the batch size are saved after every batch
(``repro_torch.train.checkpoint``, the reference's format), so a killed
run resumes at the next batch without recomputing finished ones
(Algorithm 3's outer loop is embarrassingly restartable). A resume reuses
the checkpoint's batch size; a ``--nb`` that differs exits.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import time

import numpy as np
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.bc import BCQuery, ExecutionConfig
from repro_torch.bc import plan as bc_plan
from repro_torch.bc import solve as bc_solve
from repro_torch.core.brandes_ref import (brandes_bc, cc_ref, closeness_ref,
                                          khop_ref)
from repro_torch.core.metrics import METRICS
from repro_torch.graphs.generators import from_spec
from repro_torch.launch.mesh import mesh_from_spec, parse_mesh_spec
from repro_torch.train import checkpoint as ckpt_lib

# --verify oracles per metric: (name printed, oracle(g, hops))
_ORACLES = {"betweenness": ("the Brandes", lambda g, hops: brandes_bc(g)),
            "closeness": ("closeness_ref", lambda g, hops: closeness_ref(g)),
            "khop": ("khop_ref", lambda g, hops: khop_ref(g, hops=hops)),
            "components": ("cc_ref", lambda g, hops: cc_ref(g))}


def _parse_approx(spec: str):
    try:
        eps_s, delta_s = spec.split(",")
        eps, delta = float(eps_s), float(delta_s)
    except ValueError:
        raise SystemExit(
            f"--approx expects 'eps,delta' (e.g. 0.05,0.1), got {spec!r}")
    if not (0 < eps < 1 and 0 < delta < 1):
        raise SystemExit(f"--approx eps and delta must be in (0, 1), got "
                         f"eps={eps} delta={delta}")
    return eps, delta


def _report_approx(g, res, args, eps, delta):
    ids = res.topk(args.topk)
    print(f"[bc] top-{args.topk} central vertices (λ̂ ± CI):")
    for v in ids:
        print(f"[bc]   v={int(v):6d}  {res.lam[v]:12.2f} ± "
              f"{res.halfwidth[v]:.2f}")
    if not args.verify:
        return
    name, oracle = _ORACLES[args.metric]
    ref = oracle(g, args.hops)
    top_ref = set(np.argsort(ref)[::-1][:args.topk].tolist())
    prec = len(top_ref & set(ids.tolist())) / args.topk
    if args.metric != "betweenness":
        # Other metrics have their own normalization constants; the ε
        # bound below is the BC one, so check the ranking only.
        print(f"[bc] vs {name} oracle: top-{args.topk} precision {prec:.2f}")
        return
    err = float(np.abs(res.lam - ref).max()) / (g.n * max(g.n - 2, 1))
    print(f"[bc] vs Brandes oracle: max normalized error {err:.4f} "
          f"(eps={eps}), top-{args.topk} precision {prec:.2f}")
    if err > eps:
        # Legitimate with probability ≤ delta (and the "normal" rule's
        # CIs are a CLT profile, not a concentration bound): warn.
        print(f"[bc] WARNING: error {err:.4f} exceeds eps={eps} "
              f"(expected with probability <= {delta})")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--graph", default="rmat",
                    choices=["rmat", "uniform", "er"])
    ap.add_argument("--scale", type=int, default=8)
    ap.add_argument("--degree", type=int, default=8)
    ap.add_argument("--weighted", action="store_true")
    ap.add_argument("--nb", type=int, default=64,
                    help="batch size (0 = the planner's cost-model pick)")
    ap.add_argument("--backend", default="auto",
                    choices=["auto", "dense", "coo", "csr"],
                    help="relax backend (auto = the planner's regime "
                         "choice)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--verify", action="store_true",
                    help="check against the Brandes oracle (slow)")
    ap.add_argument("--approx", default="",
                    help="eps,delta — run adaptive-sampling approximate BC")
    ap.add_argument("--topk", type=int, default=10,
                    help="top-k query size for --approx")
    ap.add_argument("--strategy", default="adaptive",
                    choices=["adaptive", "uniform"])
    ap.add_argument("--rule", default="bernstein",
                    choices=["bernstein", "normal"])
    ap.add_argument("--max-samples", type=int, default=0)
    ap.add_argument("--mesh", default="",
                    help="DxM or PxDxM axis sizes — pin placement to the "
                         "distributed moments step (every rank of a "
                         "torchrun job runs it; needs --approx)")
    ap.add_argument("--dist-backend", default=None, choices=["nccl", "gloo"],
                    help="process-group backend of --mesh")
    ap.add_argument("--metric", default="betweenness", choices=METRICS,
                    help="graph metric to solve (MetricSpec registry)")
    ap.add_argument("--hops", type=int, default=0,
                    help="hop bound (edges) for --metric khop")
    ap.add_argument("--ckpt-dir", default="")
    args = ap.parse_args(argv)
    try:
        resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[bc] {e}")
    if not args.mesh:
        return _run(args, None)
    mesh = _init_mesh(args)
    quiet = (contextlib.redirect_stdout(io.StringIO()) if mesh.rank
             else contextlib.nullcontext())
    try:
        with quiet:
            return _run(args, mesh)
    finally:
        dist.destroy_process_group()


def _init_mesh(args):
    """Join the torchrun job's process group and build ``--mesh``."""
    if not args.approx:
        raise SystemExit("[bc] --mesh requires --approx (the exact mesh "
                         "sweep is repro_torch.bc.solve(..., mesh=))")
    if args.dist_backend is None:
        raise SystemExit("[bc] --mesh needs --dist-backend nccl|gloo: NCCL "
                         "for one card a rank, gloo for ranks that share a "
                         "card or run on the CPU")
    try:
        parse_mesh_spec(args.mesh)
    except ValueError as e:
        raise SystemExit(f"[bc] --mesh: {e}")
    try:
        dist.init_process_group(args.dist_backend)
    except (ValueError, RuntimeError) as e:
        raise SystemExit(f"[bc] --mesh runs under torchrun (or with "
                         f"MASTER_ADDR, MASTER_PORT, RANK and WORLD_SIZE "
                         f"set): {e}")
    try:
        mesh = mesh_from_spec(args.mesh, device=args.device)
    except ValueError as e:
        dist.destroy_process_group()
        raise SystemExit(f"[bc] --mesh: {e}")
    return mesh


def _run(args, mesh):
    g = from_spec(args.graph, scale=args.scale, degree=args.degree,
                  weighted=args.weighted, seed=args.seed)
    g, _ = g.remove_isolated()
    print(f"[bc] graph {g.name}: n={g.n} m={g.m} device={args.device}")
    if mesh is not None:
        print(f"[bc] mesh {mesh.axis_sizes} over {dist.get_world_size()} "
              f"ranks, backend {mesh.backend}, rank 0 on {mesh.device}")
    execution = ExecutionConfig(
        backend=None if args.backend == "auto" else args.backend)
    kw = dict(mode="exact")
    if args.approx:
        eps, delta = _parse_approx(args.approx)
        kw = dict(mode="approx", eps=eps, delta=delta,
                  strategy=args.strategy, rule=args.rule, topk=args.topk,
                  max_samples=args.max_samples or None)
        print(f"[bc] approx mode: eps={eps} delta={delta} "
              f"strategy={args.strategy} rule={args.rule}")
    try:
        query = BCQuery(n_b=args.nb or None, execution=execution,
                        seed=args.seed, metric=args.metric, hops=args.hops,
                        **kw)
    except ValueError as e:  # e.g. --metric khop without --hops
        raise SystemExit(f"[bc] bad query: {e}")
    start_batch, lam_acc = 0, np.zeros(g.n)
    if args.ckpt_dir and not args.approx:
        step = ckpt_lib.latest_step(args.ckpt_dir)
        if step is not None:
            flat, _ = ckpt_lib.restore(args.ckpt_dir)
            lam_acc = flat["lam"]
            start_batch = step + 1
            # The sweep's source ranges are keyed by nb: a resume must
            # reuse the checkpoint's batch size, not whatever the planner
            # (or a changed --nb) would pick today.
            ckpt_nb = int(flat["nb"]) if "nb" in flat else (args.nb or 64)
            if args.nb and args.nb != ckpt_nb:
                raise SystemExit(f"--nb {args.nb} mismatches checkpoint "
                                 f"batch size nb={ckpt_nb}")
            query = dataclasses.replace(query, n_b=ckpt_nb)
            print(f"[bc] resuming at batch {start_batch} (nb={ckpt_nb})")
    try:
        pl = bc_plan(g, query, mesh=mesh,
                     n_devices=None if mesh is not None else 1,
                     device=args.device)
    except ValueError as e:  # e.g. --mesh with --backend coo
        raise SystemExit(f"[bc] cannot plan this query: {e}")
    print(f"[bc] {pl.summary()} execution={pl.execution.describe()}")
    for note in pl.notes:
        print(f"[bc] note: {note}")

    if args.approx:
        def progress(epoch, tau, max_hw):
            print(f"[bc] epoch {epoch}: tau={tau} max_halfwidth={max_hw:.4f}")
    else:
        total_batches = -(-g.n // pl.n_b)

        def progress(b, n_batches, lam):
            gb = start_batch + b  # global batch index across resumes
            if args.ckpt_dir:
                # Cumulative λ at the global step: a second kill + resume
                # restores the whole prefix, not just this run's segment.
                ckpt_lib.save(args.ckpt_dir, gb, {"lam": lam + lam_acc,
                                                  "batch": gb,
                                                  "nb": pl.n_b})
            print(f"[bc] batch {gb + 1}/{total_batches}")

    sources = (None if args.approx
               else np.arange(start_batch * pl.n_b, g.n, dtype=np.int32))
    t0 = time.time()
    out = bc_solve(g, query, mesh=mesh, plan=pl, progress_cb=progress,
                   sources=sources, device=args.device)
    dt = time.time() - t0
    if out.plan.occupancy is not None:
        occ = out.plan.occupancy
        print(f"[bc] occupancy: {occ['relax_calls']} relax calls, hit rate "
              f"{occ['hit_rate']:.3f}, {occ['overflows']} overflows")
    # TEPS as the paper counts it: every edge is traversed once per source
    teps = g.m * out.n_samples / dt
    if args.approx:
        res = out.approx
        print(f"[bc] approx done in {dt:.2f}s — {res.n_samples} samples "
              f"({res.n_epochs} epochs, converged={res.converged}) — "
              f"{teps:,.0f} TEPS (model)")
        _report_approx(g, res, args, eps, delta)
        return res
    lam = out.lam + lam_acc
    print(f"[bc] done in {dt:.2f}s — {teps:,.0f} TEPS (model)")
    top = np.argsort(lam)[::-1][:5]
    print("[bc] top-5 central vertices:", list(zip(top.tolist(),
                                                   np.round(lam[top], 2))))
    if args.verify:
        name, oracle = _ORACLES[args.metric]
        np.testing.assert_allclose(lam, oracle(g, args.hops), rtol=1e-4,
                                   atol=1e-6)
        print(f"[bc] verified against {name} oracle")
    return lam


if __name__ == "__main__":
    main()
