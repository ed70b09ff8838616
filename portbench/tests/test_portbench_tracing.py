"""The benchmark's four readers of the program's spans and counters
(``repro_torch.tracing``) on a synthetic snapshot, and ``relax_bound_s``
against ``chip_smoke.py::relax_bound``."""
from __future__ import annotations

import ast
import sys
import types

import pytest

from conftest import REPO
from portbench.harness.result import LayerContext
from portbench.harness.spec import metric_reader
from portbench.harness.trace import DeviceTrace
from portbench.metrics.common.relax_bound import relax_bound_s
from repro_torch import tracing

RELAX = dict(rows=16, n=1000, outputs=2)
READERS = ("child_count_ms_per_batch", "csr_runs_ms_per_batch",
           "segment_relax_roofline", "host_syncs_per_batch")


def _snapshot(device_ms=1.0):
    spans, ids = [], iter(range(100))

    def add(name, parent, ms, **attrs):
        spans.append(tracing.Span(next(ids), parent, name, attrs, 0, 1,
                                  None if device_ms is None else ms))
        return spans[-1].id

    for _ in range(2):  # two calls
        b = add("batch", None, 10.0, rows=16, n=1000)
        f = add("mfbf", b, 4.0)
        r = add("csr.relax", f, 2.0, live_arcs=5000, cols=300, bucket=1,
                **RELAX)
        add("csr.runs", r, 1.5)
        m = add("mfbr", b, 5.0)
        add("child_count", m, 3.0)
        r = add("csr.relax", m, 1.0, live_arcs=200, cols=20, bucket=0,
                **dict(RELAX, outputs=3))
        add("csr.runs", r, 0.25)
    return tracing.Snapshot(spans, {"host_syncs": 10})


def _ctx(trace=True, launches=4, relax_s=1e-3):
    dt = DeviceTrace(window_s=1.0, busy_s=0.9,
                     ops=[("void segment_relax_main<true>(float)", 0.0,
                           relax_s), ("void at::native::add", 0.5, 0.6)],
                     idle_by_host={})
    return LayerContext(batches=2, trace=dt if trace else None,
                        launches={"segment_relax": launches},
                        product_shape=None, occupancy=None,
                        peak_window_bytes=0)


@pytest.fixture
def fake_snapshot(monkeypatch):
    def use(snap):
        monkeypatch.setattr(tracing, "snapshot", lambda clear=True: snap)
    return use


def test_readers_on_a_synthetic_snapshot(fake_snapshot):
    fake_snapshot(_snapshot())
    got = {name: metric_reader(name)(_ctx()) for name in READERS}
    bound = (relax_bound_s(16, 1000, 5000, 300, 2)
             + relax_bound_s(16, 1000, 200, 20, 3))
    assert got == {"child_count_ms_per_batch": 3.0,
                   "csr_runs_ms_per_batch": 1.75,
                   "segment_relax_roofline": pytest.approx(
                       100.0 * 2 * bound / 1e-3),
                   "host_syncs_per_batch": 5.0}


@pytest.mark.parametrize("name", READERS)
def test_readers_find_nothing_untraced_on_the_cpu_or_without_tracing(
        fake_snapshot, monkeypatch, name):
    read = metric_reader(name)
    fake_snapshot(_snapshot())
    assert read(_ctx(trace=False)) is None
    fake_snapshot(_snapshot(device_ms=None))
    assert (read(_ctx()) is None) == (name != "segment_relax_roofline")
    # a program without repro_torch.tracing, as the parent of this change
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "tracing")
    assert read(_ctx()) is None


def test_roofline_needs_one_span_a_launch(fake_snapshot):
    fake_snapshot(_snapshot())
    read = metric_reader("segment_relax_roofline")
    assert read(_ctx(launches=4)) is not None
    assert read(_ctx(launches=5)) is None
    assert read(_ctx(launches=0)) is None


def _smoke_relax_bound():
    """``chip_smoke.py::relax_bound`` and its peaks, read from the source
    (the script exits at import on a host without a card)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    ns = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(
                getattr(t, "id", "").startswith("PEAK_")
                for t in node.targets)) or (
                isinstance(node, ast.FunctionDef)
                and node.name == "relax_bound"):
            exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"),
                 ns)
    return ns["relax_bound"]


@pytest.mark.parametrize("rows,n,arcs,outputs", [
    (16, 646043, 31403422, 2), (16, 173847, 2_450_000, 3), (64, 100, 7, 2),
    (1, 1, 0, 3)])
def test_relax_bound_is_chip_smokes_at_every_column(rows, n, arcs, outputs):
    smoke = _smoke_relax_bound()
    runs = types.SimpleNamespace(offsets=[0, arcs])
    ms, _, _ = smoke(runs, rows, n, outputs)
    assert relax_bound_s(rows, n, arcs, n, outputs) * 1e3 == pytest.approx(
        ms, rel=1e-12)
    assert relax_bound_s(rows, n, arcs, n // 2, outputs) <= ms * 1e-3
