"""The port's spans and counters (``repro_torch.tracing``).

* With no profiler running, ``span`` is one shared no-op and nothing is
  recorded.
* Under ``torch.profiler``, an exact sweep on the CSR and the dense
  executors records the span tree ``batch ⊃ {mfbf ⊃ csr.relax ⊃
  csr.runs, mfbr ⊃ {child_count, csr.relax ⊃ csr.runs}}`` (on the dense
  adjacency ``batch ⊃ {mfbf, mfbr ⊃ child_count}``); each ``csr.relax``
  carries its relax's live arcs (the whole arc list on the fallback);
  ``host_syncs`` counts relax calls + 3 a batch; ``child_count`` carries
  its rows, n and ``dense`` (1 on the dense adjacency, 0 on the COO form
  that CSR runs); each span's host start lies within 1 ms of its
  ``repro_torch.<name>`` range in the profiler's events; λ is bitwise λ
  untraced.
* A new profile drops the spans and counts of the last one, and only
  then: a reader of a finished profile reads that profile's alone. The
  child count kernel's ``child_count.launch`` counter follows the same
  rule.
* On a one-rank gloo mesh, an exact mesh batch records ``batch ⊃ {mfbf,
  mfbr ⊃ child_count}`` once each (``child_count`` with ``dense`` 0 and
  ``mesh`` 1), one ``mesh.relax`` a local product with its shape, one
  ``mesh.collective`` a call of the mesh's wrappers with its kind and
  bytes; ``comm_bytes.<kind>`` grows by what ``Mesh.comm_bytes`` does, and
  ``host_syncs`` counts the stop tests and the copy to the host. Off, it
  records nothing.

The benchmark's readers of these spans are tested beside the benchmark,
in ``portbench/tests/test_portbench_tracing.py``.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
from torch.profiler import ProfilerActivity, profile, record_function

from repro_torch import tracing
from repro_torch.bc import BCQuery, ExecutionConfig, build_executor, plan, \
    solve
from repro_torch.core.adjacency import CsrAdj
from repro_torch.graphs.generators import rmat
from repro_torch.kernels import ops as kops
from repro_torch.launch.mesh import Mesh

NB = 16
_GRAPH = {}


def _graph():
    if not _GRAPH:
        _GRAPH["g"] = rmat(6, 8, seed=5, weighted=True,
                           max_weight=3).remove_isolated()[0]
    return _GRAPH["g"]


class _Relaxes:
    """Wraps an executor's adjacency so that each relax call is seen: the
    ``RelaxStats`` of a ``CsrAdj``, a count on the dense one."""

    def __init__(self, adj):
        self.stats, self.calls = [], 0
        self.csr = isinstance(adj, CsrAdj)
        names = (("relax_mp_stats", "relax_cp_stats") if self.csr
                 else ("relax_mp", "relax_cp"))
        for name in names:
            setattr(adj, name, self._wrap(getattr(adj, name)))

    def _wrap(self, fn):
        def relax(*args):
            out = fn(*args)
            self.calls += 1
            if self.csr:
                self.stats.append(out[1])
            return out
        return relax


def _executor(backend, caps=None):
    g = _graph()
    q = BCQuery(mode="exact", n_b=NB,
                execution=ExecutionConfig(backend=backend))
    ex = build_executor(g, plan(g, q, n_devices=1, device="cpu"),
                        device="cpu")
    if caps is not None:
        ex._adj = dataclasses.replace(ex._adj, caps=caps)
    return g, q, ex


def _batches(g):
    return [np.arange(i * NB, (i + 1) * NB, dtype=np.int32) % g.n
            for i in range(2)]


def _traced_sweep(backend, caps=None):
    """Two exact batches untraced, then the same two under the profiler:
    (λ untraced, λ traced, snapshots and relax calls of each traced batch,
    the profiler, the adjacency)."""
    g, q, ex = _executor(backend, caps)
    plain = [solve(g, q, executor=ex, sources=s).lam for s in _batches(g)]
    assert tracing.snapshot() == tracing.Snapshot([], {})
    seen = _Relaxes(ex._adj)
    got, snaps, calls = [], [], []
    # inside an outer range, as the benchmark's window is: a thread's first
    # range under the profiler pays the profiler's set-up after its start
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            record_function("window"):
        for s in _batches(g):
            before = seen.calls
            got.append(solve(g, q, executor=ex, sources=s).lam)
            snaps.append(tracing.snapshot())
            calls.append(seen.calls - before)
    return plain, got, snaps, calls, prof, ex._adj, seen


def _tree(snap):
    """{(name, parent name)} of a snapshot's spans."""
    by_id = {s.id: s for s in snap.spans}
    return {(s.name, by_id[s.parent].name if s.parent in by_id else None)
            for s in snap.spans}


def test_no_profiler_records_nothing():
    assert not torch.autograd._profiler_enabled()
    assert tracing.span("batch", rows=1) is tracing.span("mfbf")
    with tracing.span("batch", torch.device("cpu"), rows=1) as sp:
        assert sp is None
        tracing.count("host_syncs")
    g, q, ex = _executor("csr")
    solve(g, q, executor=ex, sources=_batches(g)[0])
    assert tracing.snapshot() == tracing.Snapshot([], {})


@pytest.mark.parametrize("backend,caps", [("csr", None), ("csr", ((1, 1),)),
                                          ("dense", None)])
def test_span_tree_counts_and_bitwise_lambda(backend, caps):
    plain, got, snaps, calls, prof, adj, seen = _traced_sweep(backend, caps)
    for a, b in zip(plain, got):
        assert np.array_equal(a, b)
    want = ({("batch", None), ("mfbf", "batch"), ("mfbr", "batch"),
             ("child_count", "mfbr")} if backend == "dense" else
            {("batch", None), ("mfbf", "batch"), ("mfbr", "batch"),
             ("child_count", "mfbr"), ("csr.relax", "mfbf"),
             ("csr.relax", "mfbr")})
    if caps is None and backend == "csr":
        want |= {("csr.runs", "csr.relax")}
    for snap, n_relax in zip(snaps, calls):
        assert _tree(snap) == want
        assert snap.counters == {"host_syncs": n_relax + 3}
        assert len(snap.named("batch")) == 1
        assert snap.named("batch")[0].attrs == {"rows": NB, "n": adj.n}
        mfbr = snap.named("mfbr")[0]
        kids = [s for s in snap.spans if s.parent == mfbr.id]
        assert kids[0].name == "child_count"
        assert kids[0].attrs == {"rows": NB, "n": adj.n,
                                 "dense": int(backend == "dense")}
        assert all(s.device_ms is None for s in snap.spans)
    spans = [s for snap in snaps for s in snap.spans]
    name_of = {s.id: s.name for s in spans}
    relaxes = [s for s in spans if s.name == "csr.relax"]
    assert len(relaxes) == len(seen.stats)
    for sp, st in zip(relaxes, seen.stats):
        fallback = st.overflow == 1
        assert fallback or caps is None
        assert sp.attrs == {
            "rows": NB, "n": adj.n,
            "live_arcs": adj.src.shape[0] if fallback else st.arcs,
            "cols": adj.n if fallback else st.nnz,
            "outputs": 2 if name_of[sp.parent] == "mfbf" else 3,
            "bucket": st.bucket}
    # each span's host start against its range in the profiler's events
    events = {}
    for ev in prof.profiler.kineto_results.events():
        if ev.name().startswith(tracing.PREFIX):
            events.setdefault(ev.name(), []).append(ev.start_ns())
    for name in {s.name for s in spans}:
        starts = sorted(s.start_ns for s in spans if s.name == name)
        ranges = sorted(events[tracing.PREFIX + name])
        assert len(starts) == len(ranges)
        assert max(abs(a - b) for a, b in zip(starts, ranges)) < 1e6


def test_summary_self_time():
    snap = tracing.Snapshot([
        tracing.Span(0, None, "batch", {}, 0, 4_000_000, 4.0),
        tracing.Span(1, 0, "mfbf", {}, 0, 1_000_000, 1.5),
        tracing.Span(2, 0, "mfbr", {}, 1_000_000, 3_000_000, 2.0),
        tracing.Span(3, 2, "child_count", {}, 1_000_000, 2_000_000, 0.5),
    ], {"host_syncs": 4})
    out = tracing.summary(snap)
    assert out["batch"] == {"count": 1, "host_ms": 4.0, "device_ms": 4.0,
                            "self_device_ms": 0.5}
    assert out["mfbr"]["self_device_ms"] == 1.5
    assert out["child_count"]["self_device_ms"] == 0.5


@pytest.mark.parametrize("backend", ["csr", "dense"])
def test_a_new_profile_drops_the_last_ones(backend):
    g, q, ex = _executor(backend)
    first, second = _batches(g)

    def profiled(sources):
        with profile(activities=[ProfilerActivity.CPU]), \
                record_function("window"):
            for s in sources:
                solve(g, q, executor=ex, sources=s)

    tracing.snapshot()
    profiled([first])
    one = tracing.snapshot(clear=False)
    assert len(one.named("batch")) == 1
    # untraced work between the profiles keeps the finished one readable
    solve(g, q, executor=ex, sources=second)
    assert tracing.snapshot(clear=False) == one
    profiled([first, second])
    two = tracing.snapshot(clear=False)
    assert len(two.named("batch")) == 2
    assert {s.id for s in one.spans}.isdisjoint(s.id for s in two.spans)
    assert two.counters["host_syncs"] > one.counters["host_syncs"]
    tracing.snapshot()


def test_child_count_launch_counter_keeps_one_stretch():
    """Each launch of the child count kernel adds one to its wrapper's
    ``launches`` and, while the profiler runs, to ``child_count.launch``;
    a new profile drops the last one's count (on the CPU the launch's
    bookkeeping is called without the kernel)."""
    from repro_torch.kernels import child_count as cc

    def profiled(k):
        with profile(activities=[ProfilerActivity.CPU]), \
                record_function("window"):
            for _ in range(k):
                cc._count_launch()

    tracing.snapshot()
    before = cc.child_count_cuda.launches
    cc._count_launch()  # untraced: the plain count only
    assert tracing.snapshot(clear=False) == tracing.Snapshot([], {})
    profiled(2)
    assert tracing.snapshot(clear=False).counters == {cc.LAUNCH_COUNTER: 2}
    cc._count_launch()
    assert tracing.snapshot(clear=False).counters == {cc.LAUNCH_COUNTER: 2}
    profiled(1)
    assert tracing.snapshot().counters == {cc.LAUNCH_COUNTER: 1}
    assert cc.child_count_cuda.launches == before + 5


# -- the mesh's distributed step ------------------------------------------------
@pytest.fixture
def one_rank_mesh():
    """A one-rank gloo world and its 1 x 1 mesh, for one test."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield Mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


class _MeshCalls:
    """Sees each call of the mesh's collective wrappers (kind and the
    bytes it hands over) and each local product's operand shapes."""

    def __init__(self, mesh, monkeypatch):
        self.collectives, self.products = [], []
        for name in ("all_gather", "all_reduce", "any_rank"):
            setattr(mesh, name, self._wrap(mesh, name, getattr(mesh, name)))
        for name, kind in (("multpath_matmul", "mp"),
                           ("centpath_matmul", "cp")):
            monkeypatch.setattr(kops, name,
                                self._product(kind, getattr(kops, name)))

    def _wrap(self, mesh, name, fn):
        def call(*args, **kw):
            before = dict(mesh.comm_bytes)
            out = fn(*args, **kw)
            grew = [(k, v - before[k]) for k, v in mesh.comm_bytes.items()
                    if v != before[k]]
            self.collectives.append(grew[0])
            return out
        return call

    def _product(self, kind, fn):
        def call(fw, f2, blk, splits=None):
            self.products.append({"kind": kind, "rows": fw.shape[0],
                                  "k": blk.shape[0], "cols": blk.shape[1]})
            return fn(fw, f2, blk, splits)
        return call


def _mesh_batch(mesh, monkeypatch, traced=True):
    """One exact batch on the mesh, untraced and then (``traced``) under
    the profiler: (λ untraced, λ, the snapshot, the calls seen, the comm
    bytes the batch added by kind, the batch's sweeps, the padded n)."""
    g = _graph()
    q = BCQuery(mode="exact", n_b=NB,
                execution=ExecutionConfig(backend="dense"))
    ex = build_executor(g, plan(g, q, mesh=mesh), mesh=mesh)
    sources = _batches(g)[0]
    plain = solve(g, q, executor=ex, sources=sources).lam
    tracing.snapshot()
    seen = _MeshCalls(mesh, monkeypatch)
    before = dict(mesh.comm_bytes)
    if traced:
        with profile(activities=[ProfilerActivity.CPU]), \
                record_function("window"):
            lam = solve(g, q, executor=ex, sources=sources).lam
    else:
        lam = solve(g, q, executor=ex, sources=sources).lam
    added = {k: v - before[k] for k, v in mesh.comm_bytes.items()
             if v != before[k]}
    ctx = ex._context()
    return (plain, lam, tracing.snapshot(), seen, added, ctx.sweeps,
            ctx.n_pad)


def test_mesh_batch_span_tree(one_rank_mesh, monkeypatch):
    plain, lam, snap, _, _, _, n_pad = _mesh_batch(one_rank_mesh,
                                                   monkeypatch)
    assert np.array_equal(plain, lam)
    assert _tree(snap) == {
        ("batch", None), ("mfbf", "batch"), ("mfbr", "batch"),
        ("child_count", "mfbr"), ("mesh.relax", "mfbf"),
        ("mesh.relax", "child_count"), ("mesh.relax", "mfbr"),
        ("mesh.collective", "mfbf"), ("mesh.collective", "child_count"),
        ("mesh.collective", "mfbr"), ("mesh.collective", "batch")}
    for name in ("batch", "mfbf", "mfbr", "child_count"):
        assert len(snap.named(name)) == 1, name
    assert snap.named("batch")[0].attrs == {"rows": NB, "n": _graph().n}
    assert snap.named("child_count")[0].attrs == {
        "rows": NB, "n": n_pad, "dense": 0, "mesh": 1}
    assert all(s.device_ms is None for s in snap.spans)


def test_mesh_relax_span_per_local_product(one_rank_mesh, monkeypatch):
    _, _, snap, seen, _, sweeps, n_pad = _mesh_batch(one_rank_mesh,
                                                     monkeypatch)
    relaxes = [s.attrs for s in snap.named("mesh.relax")]
    assert relaxes == seen.products
    assert len(relaxes) == sweeps[0] + sweeps[1]
    assert [a["kind"] for a in relaxes].count("mp") == sweeps[0]
    assert all(a["rows"] == NB and a["k"] == a["cols"] == n_pad
               for a in relaxes)


def test_mesh_collective_span_per_wrapper_call(one_rank_mesh, monkeypatch):
    _, _, snap, seen, added, _, _ = _mesh_batch(one_rank_mesh, monkeypatch)
    spans = [(s.attrs["kind"], s.attrs["bytes"])
             for s in snap.named("mesh.collective")]
    assert spans == seen.collectives
    by_kind = {}
    for kind, nbytes in spans:
        by_kind[kind] = by_kind.get(kind, 0) + nbytes
    assert by_kind == added


def test_mesh_comm_bytes_counters_equal_mesh_comm_bytes(one_rank_mesh,
                                                        monkeypatch):
    _, _, snap, _, added, _, _ = _mesh_batch(one_rank_mesh, monkeypatch)
    assert set(added) == {"gather", "extremum", "tie_sum", "batch", "stop"}
    assert {k[len("comm_bytes."):]: v for k, v in snap.counters.items()
            if k.startswith("comm_bytes.")} == added


def test_mesh_host_syncs_are_stop_tests_and_copies(one_rank_mesh,
                                                   monkeypatch):
    _, _, snap, seen, _, sweeps, _ = _mesh_batch(one_rank_mesh, monkeypatch)
    stops = [kind for kind, _ in seen.collectives].count("stop")
    assert stops == sweeps[2] > 0
    assert snap.counters["host_syncs"] == sweeps[2] + 1  # + λ's copy


def test_mesh_batch_untraced_records_nothing(one_rank_mesh, monkeypatch):
    plain, lam, snap, seen, added, _, _ = _mesh_batch(
        one_rank_mesh, monkeypatch, traced=False)
    assert np.array_equal(plain, lam)
    assert seen.products and seen.collectives and added
    assert snap == tracing.Snapshot([], {})
