"""Perf hillclimbing records (a port of ``repro/launch/perf_hillclimb.py``).

Three cells, as the reference's:

  gcn2d   — gcn-cora x ogb_products (multi): the port's 2D edge partition
            (``models.gnn_dist``), counted in the fake 512-rank world,
            against the dry run's GSPMD-style record of the cell.
  qwen3ep — qwen3 x train_4k (multi): experts over (pod, model), FSDP
            over data — EP degree 32 halves the per-device gathered
            expert bytes.
  bcblock — mfbc_paper x bc_web_256k (multi): the H100 product kernels'
            tile-traffic model at the per-device shape (``roofline.
            analysis.bc_kernel_model``), beside the kernels' measured time
            at that shape when the card phase passes it in. The
            reference's jnp ``block`` sweep has no counterpart: ``block``
            does not change what the card's kernels do.

Each writes ``results/perf_iters_torch/<name>.json`` with before/after
terms. gcn2d and qwen3ep read the dry run's records of their cells
(``launch.dryrun``, default ``results/dryrun_torch``).

Usage: PYTHONPATH=src python -m repro_torch.launch.perf_hillclimb \\
           --which all [--dryrun results/dryrun_torch]
"""
from __future__ import annotations

import argparse
import json
import os
from typing import Optional

OUT = "results/perf_iters_torch"


def _write(name, record, out_dir: str = OUT):
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, f"{name}.json")
    with open(path, "w") as f:
        json.dump(record, f, indent=1)
    print(f"[perf] wrote {path}")


def _read(dryrun: str, cell: str) -> Optional[dict]:
    path = os.path.join(dryrun, cell)
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def hillclimb_gcn2d(dryrun: str = "results/dryrun_torch"):
    """ogb_products on the multi-pod mesh: the dry run's record against
    the 2D edge partition (loss + gradient + the gradient sync)."""
    import torch
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.dryrun import fake_world
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models.gnn_dist import (abstract_inputs,
                                             build_gcn2d_loss, make_grid,
                                             sync_grads)
    from repro_torch.roofline.collectives import CountingMode

    fake_world(512)
    mesh = Mesh((2, 16, 16), ("pod", "data", "model"), device="cpu")
    n, e, d_in, dh, classes = 2449029, 61859140, 100, 16, 47
    grid = make_grid(mesh, n, e)
    loss2d = build_gcn2d_loss(mesh, grid, n_layers=2)
    with FakeTensorMode():
        params = {"w": [torch.empty(d_in, dh, requires_grad=True),
                        torch.empty(dh, classes, requires_grad=True)]}
        ab = abstract_inputs(mesh, grid, d_in)
        args = (ab["x"], ab["src"], ab["dst"], ab["coef"], ab["labels"],
                ab["mask"])
        mode = CountingMode()
        mode.add_arguments((params, args))
        with mode:
            loss = loss2d(params, *args)
            grads = torch.autograd.grad(loss, params["w"])
            sync_grads(mesh, grid, list(grads))
    tot = mode.stats().totals()
    after = {"flops_per_device": mode.flops,
             "bytes_accessed_per_device": mode.bytes_accessed,
             "wire_bytes": tot["wire_bytes"], "messages": tot["messages"],
             "peak_bytes": mode.peak, "argument_bytes": mode.argument_bytes}
    before = _read(dryrun, "gcn-cora__ogb_products__multi.json")
    bw = before["collectives"]["wire_bytes"] if before else None
    rec = {
        "cell": "gcn-cora x ogb_products x multi",
        "hypothesis": ("message passing over DTensors gathers the node "
                       "features and reduces a full-size partial (the "
                       "paper's 1D variant C, ~2|H| bytes/dev/layer); the "
                       "2D edge partition should cut collectives "
                       "~R*C*2/(R+C)=21x (R=32, C=16)"),
        "before_wire_bytes": bw,
        "after_wire_bytes": after["wire_bytes"],
        "win": (bw / max(after["wire_bytes"], 1.0)) if bw else None,
        "before": ({k: before.get(k) for k in
                    ("flops_per_device", "bytes_accessed_per_device")}
                   if before else None),
        "after": after,
        "note": ("before = full train step (loss+grad+adamw) from the dry "
                 "run; after = loss+grad+the gradient sync (the optimizer "
                 "on replicated, tiny parameters is left out)."),
    }
    _write("gcn2d", rec)
    return rec


def hillclimb_qwen3_ep(dryrun: str = "results/dryrun_torch"):
    """qwen3 train_4k multi: experts over (pod, model) (EP degree 32)."""
    from repro_torch.launch.dryrun import run_one

    after = run_one("qwen3-moe-235b-a22b", "train_4k", "multi",
                    os.path.join(OUT, "qwen3ep_raw"),
                    policy_overrides={"expert": ("pod", "model"),
                                      "fsdp": ("data",)})
    before = _read(dryrun, "qwen3-moe-235b-a22b__train_4k__multi.json")
    bw = before["collectives"]["wire_bytes"] if before else None
    rec = {
        "cell": "qwen3-moe x train_4k x multi",
        "hypothesis": ("FSDP gathers of expert weights dominate the wire "
                       "at EP=16; sharding experts over (pod, model) "
                       "doubles EP to 32 and should halve per-device "
                       "gathered expert bytes"),
        "before_wire_bytes": bw,
        "after_wire_bytes": after["collectives"]["wire_bytes"],
        "win": (bw / max(after["collectives"]["wire_bytes"], 1.0)
                if bw else None),
        "before_mem": before["memory"] if before else None,
        "after_mem": after["memory"],
    }
    _write("qwen3ep", rec)
    return rec


def hillclimb_bc_blocks(measured: Optional[dict] = None):
    """mfbc_paper bc_web_256k multi: the H100 kernels' tile model at the
    per-device shape (nb/pod, n/16) x (n/16, n/16), beside ``measured``
    ({kernel name: ms a launch at that shape}) when given."""
    from repro_torch.roofline import constants as C
    from repro_torch.roofline.analysis import bc_kernel_model

    n, nb, iters = 262144, 8192, 8
    nb_loc, n_loc = nb // 2, n // 16
    relaxes = 2 * (iters + 1) + 1
    per = {name: bc_kernel_model(nb_loc, n_loc, n_loc, n_out)
           for name, n_out in (("multpath_mm", 2), ("centpath_mm", 3))}
    rec = {
        "cell": "mfbc_paper x bc_web_256k x multi",
        "shape": [nb_loc, n_loc, n_loc],
        "hypothesis": ("the H100 kernels tile 64 x 64 over the full batch "
                       "with split-K: at nb_loc = 4096 each A tile is read "
                       "64 times, F once per 64-column tile; the "
                       "instruction term (2·nb·n·n2 at 33.5 T/s) should "
                       "dominate the bytes (at 3.35 TB/s) by about 10x"),
        "kernel_tile_model": per,
        "relaxes_per_batch": relaxes,
        "t_batch_model_s": {k: max(v["t_memory_s"], v["t_compute_s"])
                            * relaxes for k, v in per.items()},
        "measured_ms": measured,
        "hw": {"hbm_bw": C.HBM_BW, "instr_rate": C.INSTR_RATE},
    }
    _write("bcblock", rec)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--which", default="all",
                    choices=["all", "gcn2d", "qwen3ep", "bcblock"])
    ap.add_argument("--dryrun", default="results/dryrun_torch")
    args = ap.parse_args(argv)
    if args.which in ("all", "gcn2d"):
        hillclimb_gcn2d(args.dryrun)
    if args.which in ("all", "qwen3ep"):
        hillclimb_qwen3_ep(args.dryrun)
    if args.which in ("all", "bcblock"):
        hillclimb_bc_blocks()


if __name__ == "__main__":
    main()
