"""The check that decides ``correct`` has to fail.

* The control: the reference computed in bfloat16 (the precision below
  the configurations' float32) in the program's place reads over each
  cell's limit, here at a size a test run holds, and on the card at the
  cell's own size (``-m cuda``; ``portbench/tools/control.py`` prints
  the readings).
* The faults: a run with the timed path broken underneath, the look for
  a card skipped, comes out not correct: a batch step that returns its
  state unchanged, half of each batch left out with the rest scaled up
  (the mean over the rest), and an answer altered where it is produced.
  Each fault is a ``sitecustomize.py`` that patches the program in the
  run's process.
"""
from __future__ import annotations

import json

import pytest

from conftest import REPO, last_json, run_cell

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

FAULTS = {
    "state_unchanged": """
import numpy as np
import repro_torch.bc.executor as E

def _sum(self, src, val):
    return np.zeros(self._g.n)

E.SingleHostExecutor._sum = _sum
""",
    "half_batch": """
import repro_torch.bc.executor as E

def halve(orig):
    def _sum(self, src, val):
        val = val.copy()
        val[len(val) // 2:] = False
        return 2.0 * orig(self, src, val)
    return _sum

E.SingleHostExecutor._sum = halve(E.SingleHostExecutor._sum)
""",
    "altered": """
import repro_torch.bc.executor as E

def alter(orig):
    def _sum(self, src, val):
        lam = orig(self, src, val)
        lam[int(lam.argmax())] *= 1.01
        return lam
    return _sum

E.SingleHostExecutor._sum = alter(E.SingleHostExecutor._sum)
""",
}
CASES = [(cell, f) for cell in ("tiny.dense", "tiny.auto") for f in FAULTS]


@pytest.mark.parametrize("cell,fault", CASES)
def test_a_broken_timed_path_comes_out_not_correct(tiny_root, tmp_path,
                                                   cell, fault):
    (tmp_path / "sitecustomize.py").write_text(FAULTS[fault])
    rc, out, err = run_cell(tiny_root, cell, seconds=0.5, seed=11,
                            extra_path=[tmp_path])
    assert rc == 0, err
    res = last_json(out)
    assert res["correct"] is False, (fault, res)
    assert res["failed"] >= 1
    c = res["checks"]["lam_rel_err"]
    assert not c["value"] <= c["limit"]


def _test_size(cell: str) -> dict:
    """The cell's configuration cut to a size a test run holds: R-MAT to
    scale 10, G(n, p) to n = 2048 at the same mean degree."""
    conf = next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    path = next(c["file"] for c in BENCH["configs"] if c["name"] == conf)
    cfg = json.loads((REPO / path).read_text())
    if "scale" in cfg:
        return {**cfg, "scale": 10}
    return {**cfg, "n": 2048, "p_edge": cfg["p_edge"] * cfg["n"] / 2048}


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_fails_the_cells_limit_at_test_size(cell, seed):
    limit = json.loads((REPO / "portbench" / "workloads"
                        / f"{cell}.json").read_text())["check"]["limits"][
                            "lam_rel_err"]
    from portbench.harness import graphs
    from portbench.tools.control import reading

    cfg = _test_size(cell)
    r = reading(graphs.generate(cfg), 16, seed, "cpu", 4)
    assert r > limit, r


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_the_cells_limit_at_its_own_size(cell):
    """On the card: ``python -m pytest -m cuda portbench/tests``."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from portbench.harness.spec import load_cell
    from portbench.tools.control import cell_reading

    c = load_cell(cell)
    limit = c.workload["check"]["limits"]["lam_rel_err"]
    for seed in (101, 102, 103):
        assert cell_reading(c, seed, "cuda") > limit
