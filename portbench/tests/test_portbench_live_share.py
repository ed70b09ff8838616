"""The readers of the products' live k on synthetic snapshots and traces:
``products_live_share`` (the program's ``products.k_live`` over
``products.k``, from the recorder on one card and from rank 0's shipped
snapshot on the mesh), the bounds over the live k
(``multpath_mm_live_roofline``, ``centpath_mm_live_roofline``,
``mesh_products_live_roofline``) and ``live_k_ms_per_batch``; each gives
nothing without a trace, without the counters (a parent whose products
sweep every k) or without the recorder."""
from __future__ import annotations

import sys

import pytest

from portbench.drivers.mesh_sweep import MeshLayerContext
from portbench.harness.result import LayerContext
from portbench.harness.spec import metric_reader
from portbench.harness.trace import DeviceTrace
from portbench.metrics.common.bounds import product_bound_s
from repro_torch import tracing

COUNTERS = {"products.k": 18 * 65536, "products.k_live": 600_000,
            "products.k_live.multpath_mm": 250_000,
            "products.k_live.centpath_mm": 350_000, "host_syncs": 20}
# (name, start, end) as the trace gives them: multpath 0.2 s, centpath
# 0.3 s, the packing 0.004 s
OPS = [("void (anonymous namespace)::multpath_mm_kernel<true>(float const*)",
        0.0, 0.15),
       ("void (anonymous namespace)::multpath_fold_kernel(float const*)",
        0.15, 0.2),
       ("void (anonymous namespace)::centpath_mm_kernel<true>(float const*)",
        0.2, 0.5),
       ("(anonymous namespace)::live_k_scan(float const*, unsigned char*)",
        0.5, 0.501),
       ("(anonymous namespace)::live_k_gather(float const*, float const*)",
        0.501, 0.504),
       ("void at::native::elementwise_kernel<128, 2>", 0.504, 0.6)]


def _ctx(trace=True):
    dt = DeviceTrace(window_s=1.0, busy_s=0.9, ops=list(OPS),
                     idle_by_host={})
    return LayerContext(batches=2, trace=dt if trace else None,
                        launches={"multpath_mm": 9, "centpath_mm": 9},
                        product_shape=(64, 65536, 65536), occupancy=None,
                        peak_window_bytes=0)


@pytest.fixture
def fake_snapshot(monkeypatch):
    def use(counters):
        snap = tracing.Snapshot([], dict(counters))
        monkeypatch.setattr(tracing, "snapshot", lambda clear=True: snap)
    return use


def test_share_of_the_window_on_one_card(fake_snapshot):
    fake_snapshot(COUNTERS)
    read = metric_reader("products_live_share")
    assert read(_ctx()) == pytest.approx(600_000 / (18 * 65536))


def test_share_from_rank_zeros_snapshot(fake_snapshot):
    """The mesh's context carries rank 0's snapshot; the process's own
    recorder (empty here) is not read."""
    fake_snapshot({})
    ctx = MeshLayerContext(**vars(_ctx()), snapshot=tracing.Snapshot(
        [], {"products.k": 4 * 32768, "products.k_live": 32768}))
    assert metric_reader("products_live_share")(ctx) == 0.25


@pytest.mark.parametrize("counters", [{}, {"host_syncs": 3},
                                      {"products.k": 0,
                                       "products.k_live": 0},
                                      {"products.k": 100}])
def test_nothing_without_the_counters(fake_snapshot, counters):
    fake_snapshot(counters)
    assert metric_reader("products_live_share")(_ctx()) is None


def test_nothing_untraced_or_without_the_recorder(fake_snapshot,
                                                  monkeypatch):
    fake_snapshot(COUNTERS)
    read = metric_reader("products_live_share")
    assert read(_ctx(trace=False)) is None
    monkeypatch.setitem(sys.modules, "repro_torch.tracing", None)
    monkeypatch.delattr(sys.modules["repro_torch"], "tracing")
    assert read(_ctx()) is None


@pytest.mark.parametrize("kernel,t", [("multpath_mm", 0.2),
                                      ("centpath_mm", 0.3)])
def test_live_roofline_on_one_card(fake_snapshot, kernel, t):
    """The window's launches at the cell's shape, each at the kind's mean
    live k, over the file's kernel time; ``products.k`` must be every
    launch's n."""
    fake_snapshot(COUNTERS)
    read = metric_reader(f"{kernel}_live_roofline")
    live = COUNTERS[f"products.k_live.{kernel}"]
    want = 100.0 * 9 * product_bound_s(kernel, 64, live / 9, 65536) / t
    assert read(_ctx()) == pytest.approx(want)
    # below the full-k share by about the live share
    full = metric_reader(f"{kernel}_roofline")(_ctx())
    assert read(_ctx()) < full
    assert read(_ctx()) == pytest.approx(full * live / (9 * 65536),
                                         rel=1e-3)


@pytest.mark.parametrize("kernel", ["multpath_mm", "centpath_mm"])
@pytest.mark.parametrize("counters", [
    {},  # the parent: no live k counted
    {"products.k": 18 * 65536, "products.k_live": 600_000},
    {**COUNTERS, "products.k": 17 * 65536}])  # a launch not counted
def test_live_roofline_nothing_without_the_counts(fake_snapshot, kernel,
                                                  counters):
    fake_snapshot(counters)
    read = metric_reader(f"{kernel}_live_roofline")
    assert read(_ctx()) is None
    fake_snapshot(COUNTERS)
    assert read(_ctx(trace=False)) is None


def _mesh_ctx(snapshot, launches):
    ctx = MeshLayerContext(**vars(_ctx()), snapshot=snapshot)
    ctx.launches = launches
    return ctx


def _mesh_snapshot(counters):
    spans = [tracing.Span(i, None, "mesh.relax",
                          {"kind": kind, "rows": 32, "k": 4096,
                           "cols": 2048}, 0, 1, 1.0)
             for i, kind in enumerate(("mp", "mp", "cp"))]
    return tracing.Snapshot(spans, counters)


MESH_COUNTERS = {"products.k": 3 * 4096, "products.k_live": 5000,
                 "products.k_live.multpath_mm": 4096,
                 "products.k_live.centpath_mm": 904}


def test_mesh_live_roofline():
    """Each span at its k times its kind's live share, over both files'
    kernel time on rank 0."""
    read = metric_reader("mesh_products_live_roofline")
    ctx = _mesh_ctx(_mesh_snapshot(MESH_COUNTERS),
                    {"multpath_mm": 2, "centpath_mm": 1})
    bound = (2 * product_bound_s("multpath_mm", 32, 2048, 2048)
             + product_bound_s("centpath_mm", 32, 904, 2048))
    assert read(ctx) == pytest.approx(100.0 * bound / 0.5)


@pytest.mark.parametrize("counters,launches", [
    ({}, {"multpath_mm": 2, "centpath_mm": 1}),  # the parent
    ({"products.k": 3 * 4096, "products.k_live": 5000},
     {"multpath_mm": 2, "centpath_mm": 1}),
    ({**MESH_COUNTERS, "products.k": 4 * 4096},  # a product with no span
     {"multpath_mm": 2, "centpath_mm": 1}),
    (MESH_COUNTERS, {"multpath_mm": 3, "centpath_mm": 1})])
def test_mesh_live_roofline_nothing_without_matching_counts(counters,
                                                            launches):
    read = metric_reader("mesh_products_live_roofline")
    assert read(_mesh_ctx(_mesh_snapshot(counters), launches)) is None
    assert read(_ctx()) is None  # a single card's context


def test_live_k_ms_per_batch():
    """Both packing kernels' device time a call; nothing where the trace
    has none of it (the parent), or untraced."""
    read = metric_reader("live_k_ms_per_batch")
    assert read(_ctx()) == pytest.approx(1e3 * 0.004 / 2)
    ctx = _ctx()
    ctx.trace.ops = [op for op in OPS if "live_k" not in op[0]]
    assert read(ctx) is None
    assert read(_ctx(trace=False)) is None
