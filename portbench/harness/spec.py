"""Find a cell and everything that belongs to it, by name.

``BENCHMARK.json`` at the checkout's root is the index. A cell names its
configuration and its traffic mix there; each lives in a file of its own:

* ``<config entry's file>``: the configuration (``configs/<config>.json``);
* ``portbench/traffic/<traffic>.json``: the mix's parameters, with the
  name of the general driver that reads them (``drivers/<driver>.py``);
* ``portbench/workloads/<cell>.json``: what belongs to the cell alone
  (how many of its answers are checked, and each compared number's limit);
* ``portbench/metrics/<metric>.py``: a per-layer metric's reader.

A later cell, mix or metric is new files and new entries: nothing here
names one.
"""
from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional

ROOT = Path(__file__).resolve().parents[2]  # the checkout
BENCH_DIR = "portbench"


@dataclasses.dataclass
class Cell:
    """One entry of ``workloads`` with its files read."""

    name: str
    chips: int
    config_name: str
    config: Dict
    traffic_name: str
    traffic: Dict
    workload: Dict
    end_to_end: List[Dict]  # the cell's end-to-end metric entries
    per_layer: List[Dict]  # the cell's per-layer metric entries
    root: Path


def _read_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def _applies(metric: Dict, cell: str, e2e_names) -> bool:
    """A metric with ``workloads`` belongs to the cells it lists; one
    without, to every cell that reports the end-to-end metric it moves
    (an end-to-end metric without the key belongs to every cell)."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return "moves" not in metric or metric["moves"] in e2e_names


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = _read_json(root / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        known = ", ".join(w["name"] for w in bench["workloads"])
        raise KeyError(f"no workload {name!r} in BENCHMARK.json ({known})")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"] if _applies(m, name, ())]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if _applies(m, name, e2e_names)]
    base = root / BENCH_DIR
    return Cell(name=name, chips=int(entry["chips"]),
                config_name=conf["name"],
                config=_read_json(root / conf["file"]),
                traffic_name=entry["traffic"],
                traffic=_read_json(base / "traffic"
                                   / f"{entry['traffic']}.json"),
                workload=_read_json(base / "workloads" / f"{name}.json"),
                end_to_end=e2e, per_layer=per_layer, root=root)


def load_driver(cell: Cell):
    """The general driver module the cell's traffic mix names."""
    return importlib.import_module(f"portbench.drivers.{cell.traffic['driver']}")


def metric_reader(name: str, root: Path = ROOT) -> Callable:
    """``read(ctx) -> float | None`` of ``metrics/<name>.py``."""
    path = root / BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"portbench_metric_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def read_metrics(cell: Cell, ctx) -> Dict[str, Dict]:
    """Each per-layer metric of the cell that its reader finds, with its
    unit; a reader that finds nothing leaves its metric out."""
    out: Dict[str, Dict] = {}
    for m in cell.per_layer:
        value: Optional[float] = metric_reader(m["name"], cell.root)(ctx)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
