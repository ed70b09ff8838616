"""The mesh sweep (``drivers/mesh_sweep.py``) on four gloo ranks on the
CPU, at a tiny G(n, p) graph on the committed ``dense_mesh4`` mix: a sound
run is correct and its traced run reads the mesh's counters; a planted
fault (one rank's block of A altered) comes out not correct; a rank that
exits ends the run non-zero at once, with no result. The three mesh
readers on a synthetic snapshot."""
from __future__ import annotations

import json
import re
import time

import pytest

from conftest import REPO, last_json, make_root, run_cell
from portbench.harness.result import LayerContext
from portbench.harness.spec import metric_reader
from portbench.harness.trace import DeviceTrace
from portbench.metrics.common.bounds import product_bound_s
from repro_torch import tracing

CELL = "tiny.mesh4"  # tiny_er (n 96, batch 16) on the 2 x 2 mesh
COMMITTED = "er64k.dense-mesh4"
READERS = ("comm_bytes_per_batch", "collective_ms_per_batch",
           "mesh_products_roofline")

FAULTS = {
    # rank 1's block of A (not of its transpose) one heavier on every arc
    "block_altered": """
import torch
import torch.distributed as dist
import repro_torch.core.dist_bc as D

def alter(orig):
    def upload(self, chunks):
        out = orig(self, chunks)
        if dist.get_rank() == 1:
            self._a = torch.where(torch.isfinite(self._a), self._a + 1.0,
                                  self._a)
        return out
    return upload

D.MeshBCContext.upload_coo_chunks = alter(D.MeshBCContext.upload_coo_chunks)
""",
    # rank 2 exits in its first call of the window (the warm batch is 1)
    "rank_exits": """
import os
import torch.distributed as dist
import repro_torch.core.dist_bc as D

CALLS = [0]

def dying(orig):
    def run_sum(self, *args, **kw):
        CALLS[0] += 1
        if dist.get_rank() == 2 and CALLS[0] == 2:
            os._exit(1)
        return orig(self, *args, **kw)
    return run_sum

D.MeshBCContext.run_sum = dying(D.MeshBCContext.run_sum)
""",
}


@pytest.fixture(scope="module")
def mesh_root(tmp_path_factory):
    """A checkout with the tiny cells and ``tiny.mesh4`` added as a later
    change adds a cell: on the committed mix, reported by the committed
    cell's readers, with its check."""
    root = make_root(tmp_path_factory.mktemp("mesh"))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": CELL, "config": "tiny_er",
                               "traffic": "dense_mesh4", "chips": 4,
                               "why": "test"})
    for m in bench["per_layer"]:
        if COMMITTED in m["workloads"]:
            m["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    (root / "portbench" / "workloads" / f"{CELL}.json").write_text(
        (REPO / "portbench" / "workloads" / f"{COMMITTED}.json").read_text())
    return root


def test_sound_run_is_correct(mesh_root):
    rc, out, err = run_cell(mesh_root, CELL, seed=2**33 + 5, seconds=1.0)
    assert rc == 0, err
    res = last_json(out)
    assert res["correct"] is True and res["failed"] == 0, err
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"teps", "setup_s"}
    assert res["device"]["count"] == 4
    assert res["checks"]["lam_rel_err"]["value"] < 1e-5


def test_traced_run_reads_rank_zeros_comm_bytes(mesh_root):
    """On the CPU the counters are there and the device metrics are not
    (no NCCL kernel, no product kernel launched)."""
    rc, out, err = run_cell(mesh_root, CELL, seed=3, seconds=1.0, trace=1)
    assert rc == 0, err
    res = last_json(out)
    assert res["correct"] is True, err
    assert set(res["metrics"]) == {"comm_bytes_per_batch"}
    a_call = float(re.search(r"a call ([0-9.e+]+) B", err).group(1))
    got = res["metrics"]["comm_bytes_per_batch"]
    assert got == {"value": pytest.approx(a_call / 1e6, rel=1e-5),
                   "unit": "MB"}
    assert "span mesh.relax" in err and "span batch" in err


def test_planted_fault_is_not_correct(mesh_root, tmp_path):
    (tmp_path / "sitecustomize.py").write_text(FAULTS["block_altered"])
    rc, out, err = run_cell(mesh_root, CELL, seed=11, seconds=0.5,
                            extra_path=[tmp_path])
    assert rc == 0, err
    res = last_json(out)
    assert res["correct"] is False, res
    assert res["failed"] >= 1
    c = res["checks"]["lam_rel_err"]
    assert not c["value"] <= c["limit"]


def test_a_rank_that_exits_ends_the_run_with_no_result(mesh_root, tmp_path):
    (tmp_path / "sitecustomize.py").write_text(FAULTS["rank_exits"])
    t0 = time.monotonic()
    rc, out, err = run_cell(mesh_root, CELL, seed=12, seconds=30.0,
                            extra_path=[tmp_path])
    assert rc != 0 and out.strip() == ""
    assert re.search(r"the ranks at the failure: .*\b2 1\b", err), err
    assert time.monotonic() - t0 < 30.0  # ended before its window would


def _ctx(snapshot, launches, nccl_s=0.25, mm_s=0.5):
    dt = DeviceTrace(window_s=2.0, busy_s=1.8, ops=[
        ("ncclDevKernel_AllGather_RING_LL(ncclDevKernelArgsStorage<4096ul>)",
         0.0, nccl_s),
        ("void multpath_mm_kernel<true>(float const*)", 0.5, 0.5 + mm_s),
        ("void centpath_fold_kernel(float const*)", 1.0, 1.0 + mm_s),
        ("void at::native::add", 1.6, 1.7)], idle_by_host={})
    ctx = LayerContext(batches=2, trace=dt, launches=launches,
                       product_shape=None, occupancy=None,
                       peak_window_bytes=0)
    ctx.snapshot = snapshot
    return ctx


def _snapshot():
    spans = [tracing.Span(i, None, "mesh.relax",
                          {"kind": kind, "rows": 64, "k": 4096,
                           "cols": 2048}, 0, 1, 1.0)
             for i, kind in enumerate(("mp", "mp", "cp"))]
    return tracing.Snapshot(spans, {"comm_bytes.gather": 3_000_000,
                                    "comm_bytes.stop": 8,
                                    "host_syncs": 9})


def test_mesh_readers_on_a_synthetic_snapshot():
    read = {name: metric_reader(name) for name in READERS}
    ctx = _ctx(_snapshot(), {"multpath_mm": 2, "centpath_mm": 1})
    assert read["comm_bytes_per_batch"](ctx) == pytest.approx(1.500004)
    assert read["collective_ms_per_batch"](ctx) == pytest.approx(125.0)
    bound = (2 * product_bound_s("multpath_mm", 64, 4096, 2048)
             + product_bound_s("centpath_mm", 64, 4096, 2048))
    assert read["mesh_products_roofline"](ctx) == pytest.approx(
        100.0 * bound / 1.0)
    # spans that do not match the launches: no roofline
    ctx = _ctx(_snapshot(), {"multpath_mm": 3, "centpath_mm": 1})
    assert read["mesh_products_roofline"](ctx) is None
    # a single card's context (no snapshot), and no collective kernel
    ctx = _ctx(None, {"multpath_mm": 2, "centpath_mm": 1}, nccl_s=0.0)
    assert all(read[name](ctx) is None for name in READERS)
    # the parent program's snapshot: no mesh spans, no comm counters
    ctx = _ctx(tracing.Snapshot([], {}), {"multpath_mm": 2,
                                         "centpath_mm": 1})
    assert read["comm_bytes_per_batch"](ctx) is None
    assert read["mesh_products_roofline"](ctx) is None
