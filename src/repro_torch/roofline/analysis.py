"""Roofline analysis over the dry-run records, for the H100.

A port of ``repro/roofline/analysis.py`` over ``launch.dryrun``'s records
and the H100's constants (``roofline.constants``). For each (arch ×
shape × mesh) cell:

  compute term    = FLOPs_per_device / peak FLOP/s (bf16 tensor cores)
  memory term     = bytes_accessed_per_device / HBM bandwidth
  collective term = wire_bytes_per_device / the per-card network link

Terms are *per step* wall-time lower bounds; the dominant term is the
bottleneck. ``MODEL_FLOPS / FLOPs`` measures how much counted compute is
algorithmically useful. The estimated step time assumes perfect
compute/comm overlap (max of terms); the "roofline fraction" =
compute_term / max(terms).

The ``mfbc_paper`` cells' compute and memory terms come from the model of
the H100 product kernels (``_bc_kernel_terms``), not from the counted
step, which ran the products' plain versions on the host.

Usage:
  PYTHONPATH=src python -m repro_torch.roofline.analysis \\
      --dryrun results/dryrun_torch --out results/roofline_torch.md
"""
from __future__ import annotations

import argparse
import glob
import json
import os
from typing import Dict, List, Optional

from repro_torch.roofline import constants as C

# The product kernels' tiles (kernels/tropical_mm.py): BM batch rows by BN
# columns a block; a block reads its rows of F for its k-slice and its
# columns of A once.
BM, BN = 64, 64
BC_META = {"bc_web_256k": (262144, 8192, 8), "bc_dense_64k": (65536, 16384, 6)}


def _advice(rec: Dict, dominant: str) -> str:
    fam = rec["arch"].split("-")[0]
    if dominant == "collective":
        return ("shrink the gathered operand (2D->3D decomposition / more "
                "replication c, or keep weights resident)" if fam in
                ("mfbc_paper",) else
                "overlap or shrink DP/FSDP gathers (bigger per-device batch, "
                "int8/topk grad compression, expert-local all-to-all)")
    if dominant == "memory":
        return ("bf16/int8 the dominant resident tensor (KV cache / "
                "embedding rows / frontier pairs) or fuse the streaming op")
    return "compute-bound: raise tensor-core occupancy (bf16, larger tiles)"


def bc_kernel_model(nb: int, n: int, n2: int, n_out: int = 3) -> Dict:
    """One product (nb, n) x (n, n2) by the H100 kernels: bytes and time.

    Each BM x BN block of one of S contraction slices reads its BM rows of
    the frontier's two fields over its k range and its BN columns of A
    over the same range: F is read once per column tile (n2 / BN times), A
    once per row tile (nb / BM times; once a call at nb <= 64). The
    outputs (``n_out`` fields) are written once; split-K's partials are
    folded in place and not counted. 2·nb·n·n2 instructions (an add and a
    min/max a cell, no tensor-core form) at the instruction rate."""
    f_bytes = 8.0 * nb * n * -(-n2 // BN)
    a_bytes = 4.0 * n * n2 * -(-nb // BM)
    c_bytes = 4.0 * n_out * nb * n2
    total = f_bytes + a_bytes + c_bytes
    instr = 2.0 * nb * n * n2
    return {"f_bytes": f_bytes, "a_bytes": a_bytes, "c_bytes": c_bytes,
            "bytes": total, "t_memory_s": total / C.HBM_BW,
            "t_compute_s": instr / C.INSTR_RATE}


def _bc_kernel_terms(rec: Dict) -> Dict:
    """mfbc_paper cells: the per-device terms of the H100 product kernels
    at the cell's per-device shape, (nb/pod, n/16) x (n/16, n/16) a relax,
    2(iters + 1) + 1 relaxes a batch."""
    n, nb, iters = BC_META[rec["shape"]]
    pod = 2 if rec["mesh"] == "multi" else 1
    nb_loc, n_loc = nb // pod, n // 16
    relaxes = 2 * (iters + 1) + 1
    one = bc_kernel_model(nb_loc, n_loc, n_loc)
    return {"t_memory_s": one["t_memory_s"] * relaxes,
            "t_compute_s": one["t_compute_s"] * relaxes}


def analyze_record(rec: Dict, *, peak_flops: float = C.PEAK_FLOPS_BF16
                   ) -> Dict:
    flops_dev = rec["flops_per_device"]
    bytes_dev = rec["bytes_accessed_per_device"]
    wire = rec["collectives"].get("wire_bytes", 0.0)
    operand = rec["collectives"].get("operand_bytes", 0.0)
    t_compute = flops_dev / peak_flops
    t_memory = bytes_dev / C.HBM_BW
    t_coll = wire / C.NET_BW_PER_CARD
    if rec["arch"] == "mfbc_paper":
        kt = _bc_kernel_terms(rec)
        t_compute = kt["t_compute_s"]
        t_memory = kt["t_memory_s"]
    terms = {"compute": t_compute, "memory": t_memory, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    t_step = max(terms.values())
    model = rec.get("model_flops", 0.0)
    total = flops_dev * rec["n_devices"]
    return {
        **{k: rec[k] for k in ("arch", "shape", "mesh", "n_devices")},
        "t_compute_s": t_compute,
        "t_memory_s": t_memory,
        "t_collective_s": t_coll,
        "dominant": dominant,
        "t_step_s": t_step,
        "roofline_fraction": (t_compute / t_step) if t_step > 0 else 0.0,
        "model_flops": model,
        "hlo_flops_total": total,
        "useful_flops_ratio": model / total if total else 0.0,
        "collective_wire_bytes": wire,
        "collective_operand_bytes": operand,
        "peak_mem_gib": rec["memory"]["peak_bytes"] / 2 ** 30,
        "arg_mem_gib": rec["memory"]["argument_bytes"] / 2 ** 30,
        "advice": _advice(rec, dominant),
    }


def load_all(dryrun_dir: str) -> List[Dict]:
    out = []
    for path in sorted(glob.glob(os.path.join(dryrun_dir, "*.json"))):
        with open(path) as f:
            rec = json.load(f)
        if rec.get("ok"):
            out.append(rec)
    return out


def _fmt_t(x: float) -> str:
    if x >= 1.0:
        return f"{x:.2f}s"
    if x >= 1e-3:
        return f"{x * 1e3:.1f}ms"
    return f"{x * 1e6:.0f}us"


def to_markdown(rows: List[Dict], mesh: Optional[str] = None) -> str:
    hdr = ("| arch | shape | mesh | compute | memory | collective | bound | "
           "roofline frac | useful/counted | peak mem/dev |\n"
           "|---|---|---|---|---|---|---|---|---|---|\n")
    lines = []
    for r in rows:
        if mesh and r["mesh"] != mesh:
            continue
        lines.append(
            f"| {r['arch']} | {r['shape']} | {r['mesh']} "
            f"| {_fmt_t(r['t_compute_s'])} | {_fmt_t(r['t_memory_s'])} "
            f"| {_fmt_t(r['t_collective_s'])} | **{r['dominant']}** "
            f"| {r['roofline_fraction']:.2f} "
            f"| {r['useful_flops_ratio']:.2f} "
            f"| {r['peak_mem_gib']:.1f} GiB |")
    return hdr + "\n".join(lines) + "\n"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--dryrun", default="results/dryrun_torch")
    ap.add_argument("--out", default="results/roofline_torch.md")
    ap.add_argument("--json-out", default="results/roofline_torch.json")
    args = ap.parse_args(argv)

    rows = [analyze_record(r) for r in load_all(args.dryrun)]
    rows.sort(key=lambda r: (r["mesh"], r["arch"], r["shape"]))
    md = ["# Roofline, H100 (single: 16x16 = 256 cards)\n",
          to_markdown(rows, "single"),
          "\n# Multi-pod (2x16x16 = 512 cards) dry-run terms\n",
          to_markdown(rows, "multi")]
    for path in (args.out, args.json_out):
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("".join(md))
    with open(args.json_out, "w") as f:
        json.dump(rows, f, indent=1)
    print(f"[roofline] wrote {args.out} ({len(rows)} cells)")
    single = [r for r in rows if r["mesh"] == "single"]
    if single:
        worst = sorted(single, key=lambda r: r["roofline_fraction"])[:5]
        print("[roofline] worst roofline fractions:")
        for r in worst:
            print(f"  {r['arch']} x {r['shape']}: "
                  f"{r['roofline_fraction']:.2f} ({r['dominant']})")
    return rows


if __name__ == "__main__":
    main()
