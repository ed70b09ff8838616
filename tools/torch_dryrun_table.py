#!/usr/bin/env python3
"""Print the port's dry-run records as one markdown table, a row a cell.

    PYTHONPATH=src python3 tools/torch_dryrun_table.py [results/dryrun_torch]

Reads what ``python -m repro_torch.launch.dryrun --all --mesh both``
wrote: each cell's record (``<arch>__<shape>__<mesh>.json``) or its
failure (``.json.fail``). For each (arch, shape) of ``all_cells()`` and
each mesh it prints one rank's FLOPs, collective wire bytes and peak
memory, and the roofline's dominant term (``roofline.analysis``); a
failed or missing cell shows the last line of its error.
"""
import json
import os
import sys

from repro_torch.configs import all_cells
from repro_torch.roofline.analysis import analyze_record


def cell(out_dir: str, arch: str, shape: str, mesh: str) -> str:
    path = os.path.join(out_dir, f"{arch}__{shape}__{mesh}.json")
    if os.path.exists(path):
        with open(path) as f:
            rec = json.load(f)
        row = analyze_record(rec)
        return (f"{rec['flops_per_device']:.3g} · "
                f"{rec['collectives']['wire_bytes']:.3g} · "
                f"{rec['memory']['peak_bytes'] / 2 ** 30:.3g} · "
                f"{row['dominant']}")
    if os.path.exists(path + ".fail"):
        with open(path + ".fail") as f:
            err = json.load(f)
        last = err.get("last_line") or err["error"].strip().splitlines()[-1]
        return "FAIL: " + last.replace("[rank0]: ", "")[:90].replace("|", "/")
    return "not run"


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    out_dir = argv[0] if argv else "results/dryrun_torch"
    print("| arch | shape | single (16×16): FLOPs · wire B · peak GiB · "
          "bound | multi (2×16×16): FLOPs · wire B · peak GiB · bound |")
    print("|---|---|---|---|")
    for arch, shape in all_cells():
        print(f"| {arch} | {shape} | {cell(out_dir, arch, shape, 'single')}"
              f" | {cell(out_dir, arch, shape, 'multi')} |")


if __name__ == "__main__":
    main()
