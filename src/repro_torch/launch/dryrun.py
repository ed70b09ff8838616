"""Multi-pod dry run: every (arch × shape) cell on the production meshes,
counted on the host, one rank's view.

A port of ``repro/launch/dryrun.py``. The reference lowers and compiles
each cell's step on 512 placeholder devices and reads XLA's cost and
memory analyses; eager PyTorch has no compiler to ask, so the port runs
the step once instead, in a fake world:

* ``torch.distributed`` is initialized with the ``fake`` backend as rank
  0 of 256 (``single``, (16, 16) (data, model)) or 512 ranks (``multi``,
  (2, 16, 16) (pod, data, model)); its collectives return at once;
* the step's abstract arguments (``StepBundle.abstract_args``) are built
  under a ``FakeTensorMode`` at the cell's full size and depth: fake
  tensors, DTensors placed by the policy, which allocate nothing;
* the step runs once under ``roofline.collectives.CountingMode``, which
  tallies rank 0's FLOPs, bytes accessed, collectives (kind, bytes,
  group) and live memory.

An LM cell runs its real depth, layer by layer (no extrapolation from 1
and 2 layers: an eager loop has no scan body to correct for). BC cells
run the ``core.dist_bc`` step at their fixed iteration count with no
stop test (no host read). LM activations are sharded over the batch axes
only (``seq_shard=False``; the reference's dry run also shards the
sequence over ``model``): see ROADMAP.md queue 3.

The record keeps the reference's schema. ``seconds_lower`` is the time
to build the abstract arguments, ``seconds_compile`` the counted step's
(nothing compiles); ``memory``'s ``peak_bytes`` is the peak of live
storages, arguments included, ``argument_bytes`` the arguments',
``temp_bytes`` the difference, ``output_bytes`` the outputs' new storages,
``generated_code_bytes`` 0.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma2-27b \\
      --shape train_4k --mesh multi --out results/dryrun_torch
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--mesh both]
      # each cell in a fresh subprocess (memory isolation), skipping
      # cells whose JSON is already present
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

DEFAULT_OUT = "results/dryrun_torch"


def cell_filename(arch: str, shape: str, mesh_kind: str) -> str:
    return f"{arch}__{shape}__{mesh_kind}.json"


def fake_world(world_size: int) -> None:
    """Initialize ``torch.distributed`` as rank 0 of a fake world (no
    process, no transport; collectives complete at once)."""
    import torch.distributed as dist
    # importing it registers the ``fake`` backend on older releases
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks "
                               f"is initialized, the cell needs "
                               f"{world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def count_step(bundle):
    """Build ``bundle``'s abstract arguments under a ``FakeTensorMode`` and
    run its step once under a ``CountingMode``; returns ``(mode,
    output_bytes, seconds_args, seconds_step)``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.roofline.collectives import CountingMode, _nbytes

    with FakeTensorMode(allow_non_fake_inputs=True):
        t0 = time.time()
        args = bundle.abstract_args()
        t1 = time.time()
        mode = CountingMode()
        mode.add_arguments(args)
        arg_ids = {id(t.untyped_storage()) for t in _local(args)}
        with mode:
            out = bundle.fn(*args)
        t2 = time.time()
        out_b = _nbytes(t for t in _local(out)
                        if id(t.untyped_storage()) not in arg_ids)
        del out, args
    return mode, out_b, t1 - t0, t2 - t1


def _local(tree):
    """The local tensors of ``tree``'s tensors (a DTensor's shard)."""
    from torch.distributed.tensor import DTensor

    from repro_torch.roofline.collectives import _tensors

    return [t._local_tensor if isinstance(t, DTensor) else t
            for t in _tensors(tree)]


def run_one(arch_id: str, shape_id: str, mesh_kind: str, out_dir: str,
            policy_overrides=None) -> dict:
    from repro_torch.configs import get_arch
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.sharding.rules import make_policy

    multi = mesh_kind == "multi"
    fake_world(512 if multi else 256)
    mesh = make_production_mesh(multi_pod=multi, device_type="cpu")
    n_dev = mesh.size()
    spec = get_arch(arch_id)
    cell = spec.cells()[shape_id]
    policy = make_policy(mesh, overrides=policy_overrides)
    bundle = spec.build(cell, policy)
    mode, out_b, t_args, t_step = count_step(bundle)
    mem = {
        "argument_bytes": int(mode.argument_bytes),
        "output_bytes": int(out_b),
        "temp_bytes": int(mode.peak - mode.argument_bytes),
        "peak_bytes": int(mode.peak),
        "generated_code_bytes": 0,
    }
    record = {
        "arch": arch_id,
        "shape": shape_id,
        "mesh": mesh_kind,
        "n_devices": int(n_dev),
        "ok": True,
        "seconds_lower": round(t_args, 2),
        "seconds_compile": round(t_step, 2),
        "model_flops": bundle.model_flops,
        "flops_per_device": float(mode.flops),
        "bytes_accessed_per_device": float(mode.bytes_accessed),
        "trip_counts": dict(bundle.trip_counts),
        "collectives": mode.stats().totals(),
        "memory": mem,
    }
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, cell_filename(arch_id, shape_id, mesh_kind))
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[dryrun] OK {arch_id} x {shape_id} x {mesh_kind}: "
          f"args {t_args:.1f}s step {t_step:.1f}s "
          f"peak/dev {mem['peak_bytes'] / 2 ** 30:.2f} GiB "
          f"flops/dev {record['flops_per_device']:.3e} "
          f"wire/dev {record['collectives']['wire_bytes']:.3e} B")
    return record


def run_all(out_dir: str, mesh_kinds, only=None, timeout=3000):
    """Each cell in a fresh subprocess (isolation + incremental caching);
    a failed cell leaves ``<cell>.json.fail`` with its error."""
    from repro_torch.configs import all_cells

    failures = []
    for mesh_kind in mesh_kinds:
        for arch_id, shape_id in all_cells():
            if only and arch_id not in only:
                continue
            path = os.path.join(out_dir, cell_filename(arch_id, shape_id,
                                                       mesh_kind))
            if os.path.exists(path):
                print(f"[dryrun] cached {arch_id} x {shape_id} x {mesh_kind}")
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch_id, "--shape", shape_id,
                   "--mesh", mesh_kind, "--out", out_dir]
            print(f"[dryrun] spawn {' '.join(cmd[3:])}", flush=True)
            try:
                r = subprocess.run(cmd, capture_output=True, text=True,
                                   timeout=timeout)
                rc, out, err = r.returncode, r.stdout, r.stderr
            except subprocess.TimeoutExpired as e:
                rc, out = -9, (e.stdout or b"").decode(errors="replace")
                err = f"timed out after {timeout} s"
            sys.stdout.write(out[-2000:])
            if rc != 0:
                failures.append((arch_id, shape_id, mesh_kind))
                lines = [ln for ln in err.splitlines() if ln.strip()]
                rec = {"arch": arch_id, "shape": shape_id, "mesh": mesh_kind,
                       "ok": False, "error": err[-4000:],
                       "last_line": lines[-1] if lines else ""}
                os.makedirs(out_dir, exist_ok=True)
                with open(path + ".fail", "w") as f:
                    json.dump(rec, f, indent=1)
                print(f"[dryrun] FAIL {arch_id} x {shape_id} x {mesh_kind}: "
                      f"{rec['last_line'][-300:]}", flush=True)
    return failures


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="multi", choices=["single", "multi",
                                                        "both"])
    ap.add_argument("--out", default=DEFAULT_OUT)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--only", nargs="*", default=None)
    ap.add_argument("--timeout", type=float, default=3000,
                    help="seconds a cell's subprocess may take (--all)")
    args = ap.parse_args(argv)

    kinds = ["single", "multi"] if args.mesh == "both" else [args.mesh]
    if args.all:
        failures = run_all(args.out, kinds, only=args.only,
                           timeout=args.timeout)
        if failures:
            print("FAILURES:", failures)
            sys.exit(1)
        print("[dryrun] all cells OK")
        return
    if args.arch is None or args.shape is None:
        ap.error("--arch and --shape (or --all)")
    if len(kinds) > 1:
        ap.error("one cell runs on one mesh in a process (a fake world has "
                 "one size): --mesh single or multi, or --all")
    run_one(args.arch, args.shape, kinds[0], args.out)


if __name__ == "__main__":
    main()
