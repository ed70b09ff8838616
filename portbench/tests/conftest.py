"""Fixtures of the benchmark's CPU tests: a checkout of the benchmark in a
temporary directory, with tiny cells added the way a later change adds
one (new configuration, workload and metric files and new
``BENCHMARK.json`` entries), run through ``portbench/run.py --device
cpu``."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_CONFIGS = {
    "tiny_er": {"name": "tiny_er", "generator": "erdos_renyi", "n": 96,
                "p_edge": 4 / 96, "graph_seed": 1, "weighted": False,
                "remove_isolated": False, "batch": 16, "iters": 0,
                "precision": "float32"},
    "tiny_rmat": {"name": "tiny_rmat", "generator": "rmat", "scale": 7,
                  "edge_factor": 8, "graph_seed": 0, "weighted": True,
                  "max_weight": 100, "remove_isolated": True,
                  "permute_vertices": True, "iters": 0,
                  "precision": "float32"},
}
# (cell, config, committed traffic mix, chips, the committed cell whose
# check it takes)
TINY_CELLS = (("tiny.dense", "tiny_er", "dense_nb64", 1, "er64k.dense"),
              ("tiny.auto", "tiny_rmat", "auto", 1, "rmat20.auto"))
# a metric a later change would add: the calls in the traced window
NEW_METRIC = "tiny_calls_per_window"
NEW_READER = '''"""tiny_calls_per_window (calls): calls in the traced window."""


def read(ctx):
    return float(ctx.batches) if ctx.batches else None
'''


def make_root(dest: Path, with_src: bool = True) -> Path:
    """A checkout at ``dest``: BENCHMARK.json and portbench/ copied (no
    cache), src/ linked, the tiny cells and the new metric added."""
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    if with_src:
        os.symlink(REPO / "src", dest / "src")
    bench = json.loads((dest / "BENCHMARK.json").read_text())
    for name, cfg in TINY_CONFIGS.items():
        path = f"portbench/configs/{name}.json"
        (dest / path).write_text(json.dumps(cfg))
        bench["configs"].append({"name": name, "source": "test",
                                 "file": path, "reduced": [], "why": "t"})
    for cell, cfg, traffic, chips, like in TINY_CELLS:
        bench["workloads"].append({"name": cell, "config": cfg,
                                   "traffic": traffic, "chips": chips,
                                   "why": "test"})
        check = json.loads((REPO / "portbench" / "workloads"
                            / f"{like}.json").read_text())["check"]
        (dest / "portbench" / "workloads" / f"{cell}.json").write_text(
            json.dumps({"check": {**check, "batches": 64}}))
    tiny = [c for c, *_ in TINY_CELLS]
    for m in bench["per_layer"]:
        m["workloads"] = m["workloads"] + tiny
    bench["per_layer"].append({"name": NEW_METRIC, "unit": "calls",
                               "better": "higher", "source": "host_clock",
                               "layer": "solver facade", "moves": "teps",
                               "workloads": tiny})
    (dest / "portbench" / "metrics" / f"{NEW_METRIC}.py").write_text(
        NEW_READER)
    (dest / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return dest


@pytest.fixture(scope="session")
def tiny_root(tmp_path_factory) -> Path:
    return make_root(tmp_path_factory.mktemp("checkout"))


def run_cell(root: Path, cell: str, *, seed: int = 7, seconds: float = 1.0,
             trace: int = 0, device: str = "cpu", extra_path=(),
             timeout: float = 240):
    """``portbench/run.py`` in a process of its own; returns (returncode,
    stdout, stderr). ``extra_path`` goes first on PYTHONPATH (a
    ``sitecustomize.py`` there breaks the program under test)."""
    env = dict(os.environ, OMP_NUM_THREADS="2")  # tests run side by side
    env["PYTHONPATH"] = os.pathsep.join(
        [str(p) for p in extra_path] + [str(root / "src"), str(root)])
    argv = [sys.executable, str(root / "portbench" / "run.py"),
            "--workload", cell, "--seed", str(seed), "--seconds",
            str(seconds), "--trace", str(trace)]
    if device != "cuda":
        argv += ["--device", device]
    p = subprocess.run(argv, cwd=root, env=env, capture_output=True,
                       text=True, timeout=timeout)
    return p.returncode, p.stdout, p.stderr


def last_json(stdout: str):
    return json.loads(stdout.strip().splitlines()[-1])
