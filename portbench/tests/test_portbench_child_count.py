"""``child_count_roofline`` on a synthetic trace and snapshot, and
``child_count_bound_s`` against ``chip_smoke.py::child_count_bound``."""
from __future__ import annotations

import ast
import sys

import pytest

from conftest import REPO
from portbench.harness.result import LayerContext
from portbench.harness.spec import metric_reader
from portbench.harness.trace import DeviceTrace
from portbench.metrics.common.child_count_bound import child_count_bound_s
from repro_torch import tracing

KERNEL = ("void (anonymous namespace)::child_count_kernel<true>(float "
          "const*, float const*, int*, int, int)")


def _snapshot(dense=1, launches=2, device_ms=1.0):
    spans, ids = [], iter(range(100))

    def add(name, parent, **attrs):
        spans.append(tracing.Span(next(ids), parent, name, attrs, 0, 1,
                                  device_ms))
        return spans[-1].id

    for _ in range(2):  # two calls
        b = add("batch", None, rows=64, n=1000)
        m = add("mfbr", b)
        add("child_count", m, rows=64, n=1000, dense=dense)
    counters = {"host_syncs": 10}
    if launches:
        counters["child_count.launch"] = launches
    return tracing.Snapshot(spans, counters)


def _ctx(kernel_s=1e-3, trace=True):
    ops = [("void at::native::add", 0.5, 0.6)]
    if kernel_s:
        ops.append((KERNEL, 0.0, kernel_s))
    dt = DeviceTrace(window_s=1.0, busy_s=0.9, ops=ops, idle_by_host={})
    return LayerContext(batches=2, trace=dt if trace else None, launches={},
                        product_shape=(64, 1000, 1000), occupancy=None,
                        peak_window_bytes=0)


@pytest.fixture
def read(monkeypatch):
    def use(snap, ctx):
        monkeypatch.setattr(tracing, "snapshot", lambda clear=True: snap)
        return metric_reader("child_count_roofline")(ctx)
    return use


def test_bound_over_the_kernel_time(read):
    got = read(_snapshot(), _ctx(kernel_s=2e-3))
    assert got == pytest.approx(100.0 * 2 * child_count_bound_s(64, 1000)
                                / 2e-3)
    assert 0 < got < 100


@pytest.mark.parametrize("launches", [0, 1, 3])
def test_nothing_unless_dense_spans_equal_launches(read, launches):
    assert read(_snapshot(launches=launches), _ctx()) is None


def test_nothing_on_the_coo_form_the_cpu_or_untraced(read):
    # the COO form: its spans say dense 0, and nothing launches the kernel
    assert read(_snapshot(dense=0, launches=0), _ctx(kernel_s=0)) is None
    assert read(_snapshot(dense=0), _ctx()) is None
    # the CPU: spans and (no) launches, no time in the kernel
    assert read(_snapshot(launches=0, device_ms=None),
                _ctx(kernel_s=0)) is None
    assert read(_snapshot(), _ctx(kernel_s=0)) is None
    assert read(_snapshot(), _ctx(trace=False)) is None


def test_nothing_from_a_program_without_the_counter_or_tracing(
        read, monkeypatch):
    """The parent of this metric: ``child_count`` spans without
    attributes and no ``child_count.launch``; older still, no
    ``repro_torch.tracing``."""
    snap = _snapshot(launches=0)
    for s in snap.spans:
        s.attrs = {}
    assert read(snap, _ctx()) is None
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "tracing")
    assert metric_reader("child_count_roofline")(_ctx()) is None


def _smoke_child_count_bound():
    """``chip_smoke.py::child_count_bound`` and its peaks, read from the
    source (the script exits at import on a host without a card)."""
    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    ns = {}
    for node in tree.body:
        if (isinstance(node, ast.Assign) and any(
                getattr(t, "id", "").startswith("PEAK_")
                for t in node.targets)) or (
                isinstance(node, ast.FunctionDef)
                and node.name == "child_count_bound"):
            exec(compile(ast.Module([node], []), "chip_smoke.py", "exec"),
                 ns)
    return ns["child_count_bound"]


@pytest.mark.parametrize("rows,n", [(64, 65536), (64, 3342), (3, 1000),
                                    (16384, 65536), (1, 1)])
def test_bound_is_chip_smokes(rows, n):
    ms, by = _smoke_child_count_bound()(rows, n)
    assert child_count_bound_s(rows, n) * 1e3 == pytest.approx(ms, rel=1e-12)
    if rows == 64 and n == 65536:
        assert by == "operations" and ms == pytest.approx(16.4106, abs=1e-4)
