"""The port's out-of-core ingest and streamed shard upload against the
reference.

* ``graphs.formats``' ingest half is a numpy copy of
  ``repro.graphs.formats``: the files it writes, the chunks it reads, the
  canonical graphs ``ChunkedCSRBuilder`` / ``load_graph`` build and their
  digests are bitwise the reference's, for every chunking, format,
  symmetrization and compaction (mirrors of ``tests/test_ingest.py``).
* ``MeshBCContext.upload_coo_chunks`` / ``build_sharded_adjacency``: a
  stats-only context refuses to run; the streamed upload is bitwise the
  eager one for every chunking, and each rank's block is bitwise its cut of
  ``coo_to_dense`` (+ inf diagonal) after the row permutation — on a
  one-rank world and, as ``tests/md_ingest_check.py``, on a spawned world
  of 8 gloo ranks on the (2, 2, 2) and (4, 2) meshes, whose λ matches
  ``brandes_bc`` and the reference's mesh λ (rtol 1e-5, atol 1e-8).

The module imports neither jax nor ``repro`` at the top: the spawned ranks
import it.
"""
import datetime
import gzip
import os
import traceback

import numpy as np
import pytest
import torch.distributed as dist

from repro_torch.core.brandes_ref import brandes_bc
from repro_torch.core.dist_bc import MeshBCContext, vertex_row_permutation
from repro_torch.graphs import formats as F
from repro_torch.graphs.generators import erdos_renyi, rmat
from repro_torch.launch.mesh import Mesh

from _torch_world import finish_reference, run_reference, run_world

WORLD = 8
MESHES = {"pod": ((2, 2, 2), ("pod", "data", "model")),
          "flat": ((4, 2), ("data", "model"))}
CHUNKINGS = (1, 7, 10_000)


def _ref():
    from repro.graphs import formats

    return formats


def make_raw(n=60, nnz=400, seed=3, weighted=True):
    """A raw arc stream with duplicates and self loops (pre-canonical)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, nnz).astype(np.int32)
    dst = rng.integers(0, n, nnz).astype(np.int32)
    w = (rng.random(nnz).astype(np.float32) + 0.25 if weighted
         else np.ones(nnz, np.float32))
    return n, src, dst, w


def chunked(src, dst, w, size):
    for lo in range(0, src.shape[0], size):
        yield src[lo:lo + size], dst[lo:lo + size], w[lo:lo + size]


def assert_same_graph(a, b, name=True):
    assert (a.n, a.directed) == (b.n, b.directed)
    assert not name or a.name == b.name
    for x, y in ((a.src, b.src), (a.dst, b.dst), (a.w, b.w)):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)


def assert_same_ingest(a, b):
    assert_same_graph(a.graph, b.graph)
    assert a.digest == b.digest
    assert (a.edges_read, a.n_chunks) == (b.edges_read, b.n_chunks)
    if b.kept is None:
        assert a.kept is None
    else:
        np.testing.assert_array_equal(a.kept, b.kept)


# ------------------------------------------------------------- builder parity
@pytest.mark.parametrize("chunk", [1, 7, 64, 10_000])
@pytest.mark.parametrize("symmetrize", [False, True])
@pytest.mark.parametrize("remove_isolated", [False, True])
def test_builder_bitwise_reference(chunk, symmetrize, remove_isolated):
    R = _ref()
    n, src, dst, w = make_raw()
    got = F.ChunkedCSRBuilder(n, symmetrize=symmetrize,
                              remove_isolated=remove_isolated).add_chunks(
        chunked(src, dst, w, chunk)).finalize()
    want = R.ChunkedCSRBuilder(n, symmetrize=symmetrize,
                               remove_isolated=remove_isolated).add_chunks(
        chunked(src, dst, w, chunk)).finalize()
    assert_same_ingest(got, want)
    assert got.digest == F.graph_digest(got.graph)
    g = F.Graph(n, src, dst, w)
    g = g.symmetrize() if symmetrize else g.dedup()
    if remove_isolated:
        g, _ = g.remove_isolated()
    assert_same_graph(got.graph, g)


def test_builder_order_independence():
    n, src, dst, w = make_raw(seed=11)
    results = []
    for seed, chunk in ((0, 1), (1, 5), (2, 50), (3, 10_000)):
        order = np.random.default_rng(seed).permutation(src.shape[0])
        results.append(F.ChunkedCSRBuilder(n).add_chunks(
            chunked(src[order], dst[order], w[order], chunk)).finalize())
    for res in results[1:]:
        assert_same_graph(res.graph, results[0].graph)
        assert res.digest == results[0].digest


def test_builder_small_buffer_compaction():
    R = _ref()
    n, src, dst, w = make_raw()
    got = F.ChunkedCSRBuilder(n, buffer_edges=16).add_chunks(
        chunked(src, dst, w, 9)).finalize()
    want = R.ChunkedCSRBuilder(n, buffer_edges=16).add_chunks(
        chunked(src, dst, w, 9)).finalize()
    assert_same_ingest(got, want)


def test_builder_errors_match_reference():
    R = _ref()
    for mod in (F, R):
        b = mod.ChunkedCSRBuilder(4)
        with pytest.raises(ValueError, match="negative"):
            b.add(np.array([-1], np.int32), np.array([0], np.int32))
        with pytest.raises(ValueError, match="out of range"):
            b.add(np.array([0], np.int32), np.array([7], np.int32))
        with pytest.raises(ValueError, match="shape"):
            b.add(np.array([0], np.int32), np.array([1, 2], np.int32))
        b.finalize()
        with pytest.raises(RuntimeError, match="finalized"):
            b.add(np.array([0], np.int32), np.array([1], np.int32))


def test_builder_empty_and_min_weight():
    R = _ref()
    assert_same_ingest(F.ChunkedCSRBuilder(5).finalize(),
                       R.ChunkedCSRBuilder(5).finalize())
    src = np.array([0, 0, 0, 1], np.int32)
    dst = np.array([1, 1, 1, 2], np.int32)
    w = np.array([3.0, 1.5, 2.0, 1.0], np.float32)
    res = F.ChunkedCSRBuilder(3).add_chunks(chunked(src, dst, w, 1)
                                            ).finalize()
    assert res.graph.w[0] == np.float32(1.5)


# -------------------------------------------------------- files and readers
def _write(mod, path, g, suffix):
    if suffix.startswith("txt"):
        return mod.write_edge_list(path, g)
    return mod.write_binary_coo(path, g)


def _body(path):
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("suffix", ["txt", "txt.gz", "rcoo", "rcoo.gz"])
def test_written_files_equal_reference(tmp_path, suffix):
    """The same bytes (after gunzip: gzip stamps a time in its header)."""
    R = _ref()
    g = erdos_renyi(48, 0.12, seed=5, weighted=True, max_weight=9).dedup()
    a = _write(F, str(tmp_path / f"a.{suffix}"), g, suffix)
    b = _write(R, str(tmp_path / f"b.{suffix}"), g, suffix)
    assert _body(a) == _body(b)


@pytest.mark.parametrize("suffix", ["txt", "txt.gz", "rcoo", "rcoo.gz"])
@pytest.mark.parametrize("chunk_edges", [1, 37, 1_000_000])
def test_load_graph_bitwise_reference(tmp_path, suffix, chunk_edges):
    R = _ref()
    g = erdos_renyi(48, 0.12, seed=5, weighted=True, max_weight=9).dedup()
    path = _write(F, str(tmp_path / f"g.{suffix}"), g, suffix)
    got = F.load_graph(path, chunk_edges=chunk_edges, remove_isolated=False)
    assert_same_ingest(got, R.load_graph(path, chunk_edges=chunk_edges,
                                         remove_isolated=False))
    assert_same_graph(got.graph, g, name=False)  # a round trip: identity
    ra = F.EdgeListReader(path, chunk_edges=chunk_edges)
    rb = R.EdgeListReader(path, chunk_edges=chunk_edges)
    ca, cb = list(ra.chunks()), list(rb.chunks())
    assert len(ca) == len(cb)
    for x, y in zip(ca, cb):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    assert (ra.edges_read, ra.n_min, ra.header_n, ra.header_directed,
            ra.name, ra.fmt) == (rb.edges_read, rb.n_min, rb.header_n,
                                 rb.header_directed, rb.name, rb.fmt)


def test_text_unweighted_and_float32_round_trips(tmp_path):
    g = erdos_renyi(30, 0.15, seed=9, weighted=False).dedup()
    path = F.write_edge_list(str(tmp_path / "g.txt"), g)
    body = [ln for ln in open(path).read().splitlines()
            if not ln.startswith("#")]
    assert all(len(ln.split()) == 2 for ln in body)
    assert_same_graph(F.load_graph(path, n=g.n, remove_isolated=False).graph,
                      g, name=False)
    rng = np.random.default_rng(0)
    w = rng.random(200).astype(np.float32) * np.float32(1e-3)
    src = np.arange(200, dtype=np.int32) % 20
    dst = (np.arange(200, dtype=np.int32) + 1) % 20
    g = F.Graph(20, src, dst, w).dedup()
    path = F.write_edge_list(str(tmp_path / "w.txt"), g)
    np.testing.assert_array_equal(
        F.load_graph(path, n=20, remove_isolated=False).graph.w, g.w)


def test_rcoo_header_and_truncation(tmp_path):
    g = erdos_renyi(25, 0.2, seed=2, weighted=True).dedup()
    path = F.write_binary_coo(str(tmp_path / "g.rcoo"), g)
    reader = F.EdgeListReader(path)
    list(reader.chunks())
    assert (reader.header_n, reader.header_directed) == (g.n, g.directed)
    data = open(path, "rb").read()
    bad = tmp_path / "trunc.rcoo"
    bad.write_bytes(data[:-5])
    with pytest.raises(ValueError, match="truncated"):
        list(F.EdgeListReader(str(bad)).chunks())
    notmagic = tmp_path / "bad.rcoo"
    notmagic.write_bytes(b"XXXX" + data[4:])
    with pytest.raises(ValueError, match="magic"):
        list(F.EdgeListReader(str(notmagic)).chunks())
    with pytest.raises(ValueError, match="chunk_edges"):
        F.EdgeListReader(path, chunk_edges=0)


def test_reader_restartable(tmp_path):
    g = erdos_renyi(20, 0.2, seed=4).dedup()
    reader = F.EdgeListReader(F.write_edge_list(str(tmp_path / "g.txt"), g),
                              chunk_edges=5)
    first = [tuple(map(np.copy, c)) for c in reader.chunks()]
    second = list(reader.chunks())
    assert len(first) == len(second) > 1
    for a, b in zip(first, second):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_load_graph_pinned_n_and_isolated(tmp_path):
    R = _ref()
    g = F.Graph(10, np.array([0, 2, 4], np.int32),
                np.array([2, 4, 6], np.int32), np.ones(3, np.float32))
    path = F.write_edge_list(str(tmp_path / "g.txt"), g)
    for iso in (False, True):
        assert_same_ingest(F.load_graph(path, n=10, remove_isolated=iso),
                           R.load_graph(path, n=10, remove_isolated=iso))
    res = F.load_graph(path, n=10, remove_isolated=True)
    assert res.graph.n == 4
    np.testing.assert_array_equal(res.kept, [0, 2, 4, 6])
    with pytest.raises(ValueError, match="out of range"):
        F.load_graph(path, n=5)


def test_digest_and_stats_match_reference():
    R = _ref()
    n, src, dst, w = make_raw(seed=21)
    g = F.Graph(n, src, dst, w)
    assert F.graph_digest(g) == F.graph_digest(g.dedup()) == \
        R.graph_digest(R.Graph(n, src, dst, w))
    res = F.ChunkedCSRBuilder(n).add_chunks([(src, dst, w)]).finalize()
    want = R.ChunkedCSRBuilder(n).add_chunks([(src, dst, w)]).finalize()
    assert res.stats == F.GraphStats(**vars(want.stats))


def test_as_coo_chunks_normalizes(tmp_path):
    g = erdos_renyi(16, 0.25, seed=1).dedup()
    res = F.ChunkedCSRBuilder(g.n).add_chunks([(g.src, g.dst, g.w)]
                                              ).finalize()
    reader = F.EdgeListReader(F.write_edge_list(str(tmp_path / "g.txt"), g))
    for source in (g, res, reader, [(g.src, g.dst, g.w)]):
        chunks = list(F.as_coo_chunks(source))
        cat = [np.concatenate([c[i] for c in chunks]) for i in range(3)]
        assert_same_graph(F.Graph(g.n, *cat, directed=g.directed,
                                  name=g.name).dedup(), g)


# ------------------------------------------------ the streamed shard upload
def _expected_block(g, n_pad, axes, coords, transpose=False):
    """This rank's block of A (or Aᵀ) in the mesh's permuted row order."""
    dense = np.full((n_pad, n_pad), np.inf, np.float32)
    dense[:g.n, :g.n] = F.coo_to_dense(g)
    if transpose:
        dense = dense.T
    d, m = axes["data"], axes["model"]
    rb, cb = n_pad // m, n_pad // d
    perm = vertex_row_permutation(n_pad, d, m)
    ci = dict(zip(axes, coords))
    return dense[perm][ci["model"] * rb:(ci["model"] + 1) * rb,
                       ci["data"] * cb:(ci["data"] + 1) * cb]


def _streamed_cases(ctx, g, paths):
    """(λ eager, {(path, chunking): λ streamed}, (A, Aᵀ) blocks)."""
    sources = np.arange(g.n, dtype=np.int32)
    valid = np.ones(g.n, bool)
    lam = ctx.run_sum(sources, valid, nb=g.n)
    streamed = {}
    for path in paths:
        for chunk_edges in CHUNKINGS:
            stats = MeshBCContext(F.GraphStats.from_graph(g), ctx.mesh)
            F.build_sharded_adjacency(
                F.EdgeListReader(path, chunk_edges=chunk_edges), stats)
            streamed[(os.path.basename(path), chunk_edges)] = stats.run_sum(
                sources, valid, nb=g.n)
    return lam, streamed, (ctx._a.numpy(), ctx._at.numpy())


def _graph():
    return erdos_renyi(40, 0.15, seed=7, weighted=True, max_weight=9)


@pytest.fixture
def one_rank():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield Mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


def test_stats_only_context_refuses_and_rejects_out_of_range(one_rank):
    ctx = MeshBCContext(F.GraphStats(n=4, m=1), one_rank, iters=4)
    with pytest.raises(RuntimeError, match="no adjacency resident"):
        ctx.run_sum(np.arange(4, dtype=np.int32), np.ones(4, bool), nb=4)
    with pytest.raises(ValueError, match="out of range"):
        ctx.upload_coo_chunks([(np.array([0]), np.array([9]),
                                np.array([1.0], np.float32))])


def test_streamed_upload_bitwise_on_one_rank(tmp_path, one_rank):
    """Mirror of the reference's ``test_build_sharded_adjacency_single_
    device``, over both formats and every chunking; λ within rtol 1e-5 of
    the reference's 1×1 mesh λ."""
    import jax
    from repro.core.dist_bc import MeshBCContext as RefContext

    g = erdos_renyi(24, 0.2, seed=13, weighted=True, max_weight=5).dedup()
    paths = [F.write_edge_list(str(tmp_path / "g.txt"), g),
             F.write_binary_coo(str(tmp_path / "g.rcoo.gz"), g)]
    lam, streamed, (a, at) = _streamed_cases(MeshBCContext(g, one_rank), g,
                                             paths)
    for key, x in streamed.items():
        np.testing.assert_array_equal(x, lam, err_msg=str(key))
    axes = {"data": 1, "model": 1}
    np.testing.assert_array_equal(a, _expected_block(g, g.n, axes, (0, 0)))
    np.testing.assert_array_equal(at, _expected_block(g, g.n, axes, (0, 0),
                                                      transpose=True))
    ref = RefContext(g, jax.make_mesh((1, 1), ("data", "model")), iters=g.n)
    np.testing.assert_allclose(lam, ref.run_sum(
        np.arange(g.n, dtype=np.int32), np.ones(g.n, bool), nb=g.n),
        rtol=1e-5, atol=1e-8)


# -- the spawned world: tests/md_ingest_check.py ------------------------------
def _world_main(rank, store, results, paths):
    import torch

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=120))
        g = _graph()
        out = {}
        for key, (shape, names) in MESHES.items():
            mesh = Mesh(shape, names, device="cpu")
            stats = MeshBCContext(F.GraphStats.from_graph(g), mesh)
            try:
                stats.run_sum(np.arange(g.n, dtype=np.int32),
                              np.ones(g.n, bool), nb=g.n)
                refused = False
            except RuntimeError as e:
                refused = "no adjacency resident" in str(e)
            ctx = MeshBCContext(g, mesh)
            out[key] = (refused, mesh.coords, ctx.n_pad,
                        *_streamed_cases(ctx, g, paths))
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


_REFERENCE = r"""
import json, sys
import numpy as np
import jax
from repro.core.dist_bc import MeshBCContext
from repro.graphs import generators

spec = json.loads(sys.argv[1])
g = generators.erdos_renyi(40, 0.15, seed=7, weighted=True, max_weight=9)
out = {}
for key, (shape, names) in spec["meshes"].items():
    ctx = MeshBCContext(g, jax.make_mesh(tuple(shape), tuple(names)),
                        iters=g.n)
    out[key] = ctx.run_sum(np.arange(g.n, dtype=np.int32),
                           np.ones(g.n, bool), nb=g.n)
np.savez(spec["out"], **out)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ingest")
    g = _graph()
    paths = (F.write_edge_list(str(tmp / "g.txt"), g),
             F.write_binary_coo(str(tmp / "g.rcoo.gz"), g))
    out = str(tmp / "ref.npz")
    proc = run_reference(_REFERENCE, {"out": out, "meshes": MESHES})
    try:
        got = run_world(_world_main, WORLD, args=(paths,))
    finally:
        finish_reference(proc)
    return got, dict(np.load(out))


@pytest.mark.parametrize("m", sorted(MESHES))
def test_world_streamed_upload_bitwise_eager(world, m):
    got, _ = world
    for rank in range(WORLD):
        refused, _, _, lam, streamed, _ = got[rank][m]
        assert refused  # a stats-only context never runs
        assert set(streamed) == {(p, c) for p in ("g.txt", "g.rcoo.gz")
                                 for c in CHUNKINGS}
        for key, x in streamed.items():
            np.testing.assert_array_equal(x, lam, err_msg=str(key))
        np.testing.assert_array_equal(lam, got[0][m][3])  # same on all


@pytest.mark.parametrize("m", sorted(MESHES))
def test_world_blocks_are_the_permuted_dense_cut(world, m):
    got, _ = world
    g = _graph()
    shape, names = MESHES[m]
    axes = dict(zip(names, shape))
    for rank in range(WORLD):
        _, coords, n_pad, _, _, (a, at) = got[rank][m]
        np.testing.assert_array_equal(
            a, _expected_block(g, n_pad, axes, coords))
        np.testing.assert_array_equal(
            at, _expected_block(g, n_pad, axes, coords, transpose=True))


@pytest.mark.parametrize("m", sorted(MESHES))
def test_world_lambda_matches_brandes_and_reference(world, m):
    got, ref = world
    lam = got[0][m][3]
    np.testing.assert_allclose(lam, brandes_bc(_graph()), rtol=1e-5,
                               atol=1e-8)
    np.testing.assert_allclose(lam, ref[m], rtol=1e-5, atol=1e-8)


def test_graph_stats_plans_without_arrays():
    """The planner consumes GraphStats — no edge arrays needed to plan."""
    import repro_torch.bc as tbc

    g = rmat(10, 8, seed=7).dedup()
    stats = F.GraphStats.from_graph(g)
    q = tbc.BCQuery(mode="approx", strategy="uniform", max_samples=64)
    a = tbc.BCPlanner(calibration=None).plan(stats, q, n_devices=1,
                                             device="cpu").to_json()
    b = tbc.BCPlanner(calibration=None).plan(g, q, n_devices=1,
                                             device="cpu").to_json()
    for key in ("placement", "n_b", "backend", "regime"):
        assert a[key] == b[key], key
