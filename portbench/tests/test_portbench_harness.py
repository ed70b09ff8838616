"""The harness on the CPU: cells, mixes and metrics found by name, a new
cell and metric picked up from files alone, the reference against a
count of all paths, the result's last line, and the modules a run
loads."""
from __future__ import annotations

import itertools
import json
import subprocess
import sys

import numpy as np
import pytest

from conftest import (NEW_METRIC, REPO, TINY_CELLS, last_json, make_root,
                      run_cell)
from portbench.harness import device as D
from portbench.harness import spec as S
from portbench.harness import trace as T
from portbench.harness.result import Reservoir, lam_rel_err
from portbench.reference.brandes import batch_lambda

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("name", CELLS)
def test_committed_cell_found_by_name(name):
    cell = S.load_cell(name)
    assert cell.config["name"] == cell.config_name
    assert S.load_driver(cell).run
    assert {m["name"] for m in cell.end_to_end} == {"teps", "setup_s"}
    assert cell.per_layer, "every cell reports a per-layer metric"
    assert cell.workload["check"]["limits"]["lam_rel_err"] > 0


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_committed_metric_reader_found_by_name(metric):
    assert callable(S.metric_reader(metric))


def test_config_files_hold_their_reduced_keys():
    for conf in BENCH["configs"]:
        cfg = json.loads((REPO / conf["file"]).read_text())
        assert cfg["name"] == conf["name"]
        assert sorted(conf["reduced"]) == sorted(cfg["reduced"])
        for key in conf["reduced"]:
            assert key in cfg and key in cfg["published"]


def test_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="er64k.dense"):
        S.load_cell("no.such.cell")


def test_new_cell_and_metric_from_files_alone(tiny_root):
    """The tiny cells and ``tiny_calls_per_window`` exist only as new files
    and new entries (conftest.make_root): every file the repository has is
    the same, and BENCHMARK.json only grew. A traced run finds and reads
    them."""
    rc, out, err = run_cell(tiny_root, "tiny.dense", trace=1)
    assert rc == 0, err
    res = last_json(out)
    assert res["correct"], err
    assert res["metrics"][NEW_METRIC] == {"value": res["attempted"],
                                          "unit": "calls"}
    for path in (REPO / "portbench").rglob("*"):
        rel = path.relative_to(REPO)
        if path.is_file() and not {".cache", "__pycache__"} & set(rel.parts):
            assert (tiny_root / rel).read_bytes() == path.read_bytes(), rel
    grown = json.loads((tiny_root / "BENCHMARK.json").read_text())
    for key in ("configs", "workloads", "end_to_end"):
        assert grown[key][:len(BENCH[key])] == BENCH[key]
    for old, new in zip(BENCH["per_layer"], grown["per_layer"]):
        assert {**new, "workloads": old["workloads"]} == old


@pytest.mark.parametrize("cell", [c[0] for c in TINY_CELLS])
def test_last_line_has_exactly_the_contract_keys(tiny_root, cell):
    rc, out, err = run_cell(tiny_root, cell, trace=0, seed=2**33 + 1)
    assert rc == 0, err
    res = last_json(out)
    assert list(res) == KEYS + ["checks"]
    assert res["correct"] is True and res["failed"] == 0, err
    assert set(res["metrics"]) == {"teps", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    assert res["checks"]["lam_rel_err"]["value"] < 1e-5
    assert err.strip().splitlines()[-1].startswith(
        "[portbench] check lam_rel_err = ")
    rc, out, err = run_cell(tiny_root, cell, trace=1, seed=3)
    assert rc == 0, err
    res = last_json(out)
    assert list(res) == KEYS + ["breakdown", "checks"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert "teps" not in res["metrics"]


def test_no_card_means_no_result(tiny_root):
    """Without ``--device cpu`` the harness looks for the cell's cards;
    this host has none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    rc, out, err = run_cell(tiny_root, "tiny.dense", device="cuda")
    assert rc != 0 and out.strip() == ""
    assert "no CUDA card" in err


def test_without_the_program_the_run_fails(tmp_path):
    """A directory with only BENCHMARK.json and portbench/ holds no
    system under test: the run fails and prints no result."""
    root = make_root(tmp_path, with_src=False)
    rc, out, err = run_cell(root, "tiny.dense")
    assert rc != 0 and out.strip() == ""
    assert "repro_torch" in err


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.bc", "reprox", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, object())
    assert D.forbidden_modules() == []
    for name in ("repro", "repro.core", "jax", "jaxlib.xla", "flax"):
        monkeypatch.setitem(sys.modules, name, object())
    assert D.forbidden_modules() == ["flax", "jax", "jaxlib.xla", "repro",
                                     "repro.core"]


def test_nothing_a_run_loads_is_jax_or_the_jax_package(tiny_root):
    """Every module a run of each kind loads, compared by whole top-level
    name; and the reference alone loads nothing of the program."""
    code = f"""
import sys
sys.path[:0] = [{str(tiny_root / 'src')!r}, {str(tiny_root)!r}]
import portbench.reference.brandes
assert not [m for m in sys.modules if m.split('.')[0] == 'repro_torch']
import portbench.tools.control, portbench.tools.spread
from portbench.harness.main import run_cell
from pathlib import Path
for cell in ('tiny.dense', 'tiny.auto'):
    assert run_cell(cell, seed=1, seconds=0.5, traced=True, device='cpu',
                    t_start=0.0, root=Path({str(tiny_root)!r})) == 0
print('TOP', sorted({{m.split('.')[0] for m in sys.modules}}))
"""
    p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=240, cwd=tiny_root)
    assert p.returncode == 0, p.stderr
    top = eval(p.stdout.strip().splitlines()[-1][4:])
    assert "repro_torch" in top and "portbench" in top
    assert not set(top) & set(D.FORBIDDEN)


def _all_paths_lambda(n, edges):
    """λ by listing every simple path of a tiny undirected graph."""
    adj = {v: [] for v in range(n)}
    for u, v, w in edges:
        adj[u].append((v, w))
        adj[v].append((u, w))
    lam = np.zeros(n)
    for s, t in itertools.permutations(range(n), 2):
        paths = []

        def walk(v, seen, length):
            if v == t:
                paths.append((length, seen))
                return
            for x, w in adj[v]:
                if x not in seen:
                    walk(x, seen + (x,), length + w)

        walk(s, (s,), 0.0)
        if not paths:
            continue
        best = min(length for length, _ in paths)
        shortest = [p for length, p in paths if length == best]
        for p in shortest:
            for v in p[1:-1]:
                lam[v] += 1.0 / len(shortest)
    return lam


@pytest.mark.parametrize("seed", range(6))
def test_reference_matches_all_paths_count_with_ties(seed):
    rng = np.random.default_rng(seed)
    n = 7
    pairs = [(u, v) for u in range(n) for v in range(u + 1, n)
             if rng.random() < 0.5]
    edges = [(u, v, float(rng.integers(1, 3))) for u, v in pairs]
    src = np.array([u for u, v, _ in edges] + [v for u, v, _ in edges])
    dst = np.array([v for u, v, _ in edges] + [u for u, v, _ in edges])
    w = np.array([x for *_, x in edges] * 2, np.float32)
    want = _all_paths_lambda(n, edges)
    got = batch_lambda(n, src, dst, w, np.arange(n))
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


def test_lam_rel_err_is_relative_above_one_absolute_below():
    want = np.array([0.0, 0.5, 10.0, 1000.0])
    assert lam_rel_err(want, want) == 0.0
    assert lam_rel_err(want + [0.001, 0, 0, 0], want) == pytest.approx(1e-3)
    assert lam_rel_err(want * [1, 1, 1, 1.01], want) == pytest.approx(1e-2)
    assert lam_rel_err(want + [np.nan, 0, 0, 0], want) == float("inf")


def test_sources_are_the_seeds_whole_permutation():
    from portbench.drivers.exact_sweep import Sources

    pick = Sources(1024, 16, 2**33 + 3)
    window = np.concatenate([pick.window(i) for i in range(63)])
    assert len(set(window.tolist())) == 1008  # no source twice
    assert not set(window.tolist()) & set(pick.warm().tolist())
    assert (Sources(1024, 16, 2**33 + 3).window(5) == pick.window(5)).all()
    other = np.concatenate([Sources(1024, 16, 4).window(i)
                            for i in range(8)])
    assert len(set(other.tolist()) & set(window[:128].tolist())) < 64


def test_reservoir_is_drawn_from_the_seed():
    def draw(seed, count):
        r = Reservoir(4, seed)
        for i in range(count):
            r.offer(i)
        return r.items

    assert draw(5, 3) == [0, 1, 2]
    assert draw(5, 100) == draw(5, 100)
    assert draw(5, 100) != draw(6, 100)


def test_idle_gaps_are_named_by_the_open_host_operation():
    host = sorted([(0.0, 10.0, T.WINDOW_SPAN), (1.0, 9.0, T.SPAN + "solve"),
                   (2.0, 3.0, "aten::nonzero"), (2.2, 2.8, "cudaMemcpy")],
                  key=lambda h: (h[0], -h[1]))
    names = T._name_points(host, lambda name: name, [0.5, 1.5, 2.1, 2.5,
                                                     4.0])
    assert names == ["window:python", "solve:python", "solve:aten::nonzero",
                     "solve:cudaMemcpy", "solve:python"]
    busy, gaps = T._union(np.array([[0.0, 1.0], [0.5, 2.0], [3.0, 4.0]]))
    assert busy == 3.0 and gaps == [(2.0, 3.0)]
