"""The port's dry run (``repro_torch.launch.dryrun``), roofline
(``repro_torch.roofline``) and collective accounting, against the
reference's.

* The dry run of gcn-cora × ``molecule`` and xdeepfm × ``serve_p99`` on
  the multi mesh (512 fake ranks), each in a subprocess — the two cells
  of the reference's ``tests/test_dryrun.py``: exit 0, ``[dryrun] OK``, a
  record with the reference's keys (those its ``run_one`` writes) and a
  positive ``flops_per_device``; ``roofline.analysis`` over the records
  gives the reference's row keys.
* ``CollectiveOp.wire_bytes`` / ``operand_bytes`` equal the reference's
  for every kind; ``CollectiveStats.totals`` sums as the reference's
  (no loop scaling: an eager run records every execution).
* ``CountingMode`` on plain tensors: a matmul's 2·m·n·k FLOPs, its input
  and output bytes, the live-memory peak.
* The H100 constants and the BC kernel model's bytes at a hand-checked
  shape.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

from repro_torch.roofline import analysis
from repro_torch.roofline import constants as C
from repro_torch.roofline.collectives import (COLLECTIVE_KINDS, CollectiveOp,
                                              CollectiveStats, CountingMode)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the reference's record (repro/launch/dryrun.py, run_one)
RECORD_KEYS = {"arch", "shape", "mesh", "n_devices", "ok", "seconds_lower",
               "seconds_compile", "model_flops", "flops_per_device",
               "bytes_accessed_per_device", "trip_counts", "collectives",
               "memory"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes",
               "generated_code_bytes"}
CELLS = [("gcn-cora", "molecule"), ("xdeepfm", "serve_p99")]


@pytest.fixture(scope="module")
def records(tmp_path_factory):
    out = str(tmp_path_factory.mktemp("dryrun"))
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    procs = [(cell, subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         cell[0], "--shape", cell[1], "--mesh", "multi", "--out", out],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
        for cell in CELLS]
    res = {}
    for cell, p in procs:
        so, se = p.communicate(timeout=300)
        res[cell] = (p.returncode, so, se)
    return out, res


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_dryrun_one_cell_subprocess(records, arch, shape):
    out, res = records
    rc, so, se = res[(arch, shape)]
    assert rc == 0, se[-3000:]
    assert f"[dryrun] OK {arch} x {shape} x multi" in so
    with open(os.path.join(out, f"{arch}__{shape}__multi.json")) as f:
        rec = json.load(f)
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory"]) == MEMORY_KEYS
    assert rec["ok"] and rec["n_devices"] == 512
    assert rec["flops_per_device"] > 0
    assert rec["bytes_accessed_per_device"] > 0
    assert rec["memory"]["peak_bytes"] >= rec["memory"]["argument_bytes"] > 0
    assert {"operand_bytes", "wire_bytes", "messages"} <= set(
        rec["collectives"])


def test_roofline_over_the_records(records, tmp_path):
    from repro.roofline import analysis as janalysis

    out, _ = records
    rows = analysis.main(["--dryrun", out, "--out",
                          str(tmp_path / "r.md"), "--json-out",
                          str(tmp_path / "r.json")])
    assert len(rows) == len(CELLS)
    rec = analysis.load_all(out)[0]
    want = janalysis.analyze_record(rec)  # the reference's row, same record
    got = analysis.analyze_record(rec)
    assert set(got) == set(want)
    assert got["dominant"] in ("compute", "memory", "collective")
    assert got["t_memory_s"] == rec["bytes_accessed_per_device"] / C.HBM_BW
    md = (tmp_path / "r.md").read_text()
    assert "gcn-cora" in md and "xdeepfm" in md


@pytest.mark.parametrize("kind", COLLECTIVE_KINDS)
def test_wire_bytes_match_reference(kind):
    from repro.roofline.hlo_parse import CollectiveOp as JOp
    from repro.roofline.hlo_parse import CollectiveStats as JStats

    pairs = [(4096, 256), (256, 4096), (1000, 1000), (0, 64)]
    ops, jops = [], []
    for out_b, in_b in pairs:
        ours = CollectiveOp(kind, "c", out_b, in_b, group_size=16)
        theirs = JOp(kind, "c", out_b, in_b)
        assert ours.wire_bytes == theirs.wire_bytes
        assert ours.operand_bytes == theirs.operand_bytes
        ops.append(ours)
        jops.append(theirs)
    assert CollectiveStats(ops).totals() == JStats(jops, []).totals()


def test_counting_mode_tallies_a_matmul():
    a, b = torch.randn(32, 64), torch.randn(64, 16)
    mode = CountingMode()
    mode.add_arguments((a, b))
    with mode:
        c = a @ b
        d = c.t()  # a view: no bytes, no storage
    assert mode.flops == 2 * 32 * 64 * 16
    assert mode.bytes_accessed == 4 * (32 * 64 + 64 * 16 + 32 * 16)
    assert mode.argument_bytes == 4 * (32 * 64 + 64 * 16)
    assert mode.peak == mode.argument_bytes + 4 * 32 * 16
    assert not mode.collectives and d.shape == (16, 32)


def test_h100_constants_and_bc_model():
    assert C.PEAK_FLOPS_BF16 == 989.4e12 and C.PEAK_FLOPS_F32 == 66.9e12
    assert C.HBM_BW == 3.35e12 and C.HBM_BYTES == 80e9
    assert C.INSTR_RATE == 33.5e12
    assert C.NET_BW_PER_CARD == 50e9 and C.NVLINK_BW == 450e9
    m = analysis.bc_kernel_model(64, 65536, 65536, 2)
    # one row tile: A read once (17.2 GB); F once a 64-column tile
    assert m["a_bytes"] == 4.0 * 65536 * 65536
    assert m["f_bytes"] == 8.0 * 64 * 65536 * 1024
    assert m["t_compute_s"] == pytest.approx(2 * 64 * 65536 ** 2 / 33.5e12)
    rec = {"shape": "bc_dense_64k", "mesh": "multi"}
    t = analysis._bc_kernel_terms(rec)
    one = analysis.bc_kernel_model(8192, 4096, 4096)
    assert t["t_compute_s"] == pytest.approx(15 * one["t_compute_s"])
