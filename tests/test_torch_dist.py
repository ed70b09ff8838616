"""The port's distributed Theorem 5.1 step (slice 6) against the reference.

* One spawned world of 8 gloo ranks on the CPU runs the (2, 2, 2) and
  (4, 2) meshes of ``tests/md_distbc_check.py``,
  ``md_distbc_moments_check.py`` (the ragged batch included) and
  ``md_spgemm_check.py``, plus fused (segmented) batches, the plan JSON,
  the executor's buckets and one batch's collective bytes. A subprocess
  runs the reference's own mesh step on 8 host devices on the same graphs
  and sources. Exact λ is held to ``brandes_bc`` and to the reference's
  mesh λ, the moments to the single-host step of both packages and to the
  reference's mesh moments (rtol 1e-5, atol 1e-8; ``n_reach`` bitwise),
  every spgemm variant × semiring to the reference's single-device
  product (``w``/``c`` bitwise, ``m`` rtol 1e-6, ``p`` rtol 1e-5), and
  every rank's results to rank 0's, bitwise.
* In-process cases on a one-rank gloo world mirror the reference's 1×1
  tests (``tests/test_approx_bc.py``, ``tests/test_bc_api.py``); a 1×1
  mesh is bitwise the single-host executor.
* The byte counts of ``Mesh.comm_bytes`` equal the closed form the shapes
  give, and ``model_mesh_bytes`` equals ``benchmarks/comm_cost.py``'s.
* ``bc_run --mesh`` runs under ``torchrun`` with ``--dist-backend gloo
  --device cpu``.

The module imports neither jax nor ``repro`` at the top: the spawned ranks
import it. The tests import the reference inside their bodies.
"""
import datetime
import json
import os
import socket
import subprocess
import sys
import traceback
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

import repro_torch.bc as tbc
from repro_torch.core.dist_bc import (MeshBCContext, model_mesh_bytes,
                                      prepare_mesh_batch_step,
                                      vertex_row_permutation)
from repro_torch.core.brandes_ref import brandes_bc
from repro_torch.graphs import generators as tgen
from repro_torch.launch.mesh import (KINDS, Mesh, make_debug_mesh,
                                     mesh_from_spec, parse_mesh_spec)
from repro_torch.spgemm import (Plan, by_name, local_block, plan_specs,
                                spgemm)

from _torch_world import (REPO, TIMEOUT_S, finish_reference, run_reference,
                          run_world)

WORLD = 8

# -- the cases of tests/md_*_check.py -----------------------------------------
GRAPHS = {
    "g1": ("erdos_renyi", dict(n=40, p_edge=0.15, seed=7, weighted=True,
                               max_weight=9)),
    "g2": ("ring_of_cliques", dict(n_cliques=4, clique_size=6)),
    "g3": ("erdos_renyi", dict(n=36, p_edge=0.12, seed=11, weighted=True,
                               max_weight=5, directed=True)),
}
MESHES = {"pod": ((2, 2, 2), ("pod", "data", "model")),
          "flat": ((4, 2), ("data", "model"))}
EXACT = [("g1", "pod", 16), ("g1", "flat", 16), ("g2", "pod", 24),
         ("g3", "pod", 8)]


def _moments_cases():
    """md_distbc_moments_check.py's cases: (graph, mesh, nb, sources)."""
    rng = np.random.default_rng(0)
    n = {k: _graph(k).n for k in GRAPHS}
    out = []
    for g, mesh, nb, k in (("g1", "pod", 16, 16), ("g1", "flat", 16, 16),
                           ("g2", "pod", 24, 24), ("g3", "pod", 8, 8),
                           ("g1", "pod", 16, 5)):  # ragged: 5 of 16 rows
        out.append((g, mesh, nb, rng.integers(0, n[g], k).astype(np.int32)))
    return out


def _segmented_cases():
    """Fused batches: (graph, mesh, sources, slot_ids, n_slots)."""
    rng = np.random.default_rng(1)
    return [("g1", "pod", rng.integers(0, 40, 13).astype(np.int32),
             np.array([0] * 5 + [1] * 4 + [2] * 4, np.int32), 3),
            ("g2", "flat", rng.integers(0, 24, 20).astype(np.int32),
             rng.integers(0, 4, 20).astype(np.int32), 4)]


SPGEMM_MESHES = {"1": ((8,), ("q",)), "2": ((4, 2), ("r", "c")),
                 "3": ((2, 2, 2), ("p1", "r", "c"))}
VARIANTS = (["1d_a", "1d_b", "1d_c", "2d_ab", "2d_ac", "2d_bc"]
            + [f"3d_{x}_{yz}" for x in "lrc" for yz in ("ab", "ac", "bc")])
SEMIRINGS = ("arith", "multpath", "centpath")
M, K, N = 32, 48, 64


def _graph(name):
    kind, kw = GRAPHS[name]
    return getattr(tgen, kind)(**kw)


def _spgemm_inputs():
    """md_spgemm_check.py's operands, per semiring: (L fields, R)."""
    rng = np.random.default_rng(0)
    out = {"arith": ((rng.normal(size=(M, K)).astype(np.float32),),
                     rng.normal(size=(K, N)).astype(np.float32))}
    adj = rng.integers(1, 9, (K, N)).astype(np.float32)
    adj = np.where(rng.random((K, N)) < 0.4, adj, np.inf).astype(np.float32)
    for name, off in (("multpath", np.inf), ("centpath", -np.inf)):
        act = rng.random((M, K)) < 0.6
        fw = np.where(act, rng.integers(0, 12, (M, K)), off
                      ).astype(np.float32)
        f2 = (np.where(act, rng.integers(1, 4, (M, K)), 0) if off > 0
              else np.where(act, rng.random((M, K)), 0)).astype(np.float32)
        out[name] = ((fw, f2), adj)
    return out


def _left(name, fields):
    from repro_torch.core.monoids import Centpath, Multpath

    t = [torch.from_numpy(f) for f in fields]
    if name == "arith":
        return t[0]
    if name == "multpath":
        return Multpath(*t)
    return Centpath(t[0], t[1], (t[1] > 0).float())


def _query(kind, nb):
    if kind == "exact":
        return tbc.BCQuery(mode="exact", n_b=nb)
    return tbc.BCQuery(mode="approx", eps=0.1, delta=0.1, n_b=nb)


# -- the spawned world ---------------------------------------------------------
def _host(x):
    return tuple(v.numpy() for v in x) if isinstance(x, tuple) else x.numpy()


def _world_cases(rank: int) -> dict:
    """Every case of the module on this rank: its results, by key."""
    out = {}
    meshes = {k: Mesh(shape, names, device="cpu")
              for k, (shape, names) in MESHES.items()}
    for g, m, nb in EXACT:
        res = tbc.solve(_graph(g), _query("exact", nb), mesh=meshes[m])
        out[("exact", g, m, nb)] = res.lam
    for i, (g, m, nb, src) in enumerate(_moments_cases()):
        run, _ = prepare_mesh_batch_step(_graph(g), meshes[m], nb=nb,
                                         moments=True)
        out[("moments", i)] = run(src, np.ones(src.shape[0], bool))
    for i, (g, m, src, sid, n_slots) in enumerate(_segmented_cases()):
        ex = tbc.build_executor(_graph(g), tbc.BCPlanner(
            calibration=None).plan(_graph(g), _query("approx", 32),
                                   mesh=meshes[m]), mesh=meshes[m])
        out[("segmented", i)] = ex.step_segmented(
            src, np.ones(src.shape[0], bool), sid, n_slots)
        out[("buckets", i)] = (ex.n_b, ex.buckets)
    for m, mesh in meshes.items():
        for kind in ("exact", "approx"):
            out[("plan", m, kind)] = tbc.BCPlanner(calibration=None).plan(
                _graph("g1"), _query(kind, 16), mesh=mesh).to_json()
        # one batch's collective bytes, against the closed form
        ctx = MeshBCContext(_graph("g1"), mesh)
        src = np.arange(16, dtype=np.int32)
        mesh.reset_counts()
        ctx.run_moments(src, np.ones(16, bool), nb=16)
        out[("bytes", m)] = (dict(mesh.comm_bytes), ctx.sweeps, ctx.n_pad)
    inputs = _spgemm_inputs()
    for key, (shape, names) in SPGEMM_MESHES.items():
        mesh = Mesh(shape, names, device="cpu")
        for variant in (v for v in VARIANTS if v[0] == key):
            plan = Plan(variant, names)
            sa, sb, _ = plan_specs(plan)
            for name in SEMIRINGS:
                fields, b = inputs[name]
                c = spgemm(local_block(_left(name, fields), sa, mesh),
                           local_block(torch.from_numpy(b), sb, mesh),
                           mesh, plan, by_name(name))
                out[("spgemm", variant, name)] = _host(c)
    return out


def _world_main(rank: int, store: str, results) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=120))
        out = _world_cases(rank)
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


_REFERENCE = r"""
import json, sys
import numpy as np
import jax
from jax.sharding import Mesh
from repro import bc
from repro.bc.executor import MeshExecutor
from repro.core.dist_bc import MeshBCContext, prepare_mesh_batch_step
from repro.graphs import generators

spec = json.loads(sys.argv[1])
assert len(jax.devices()) == 8
meshes = {k: jax.make_mesh(tuple(s), tuple(n))
          for k, (s, n) in spec["meshes"].items()}
graphs = {k: getattr(generators, kind)(**kw)
          for k, (kind, kw) in spec["graphs"].items()}
out, plans = {}, {}
for g, m, nb in spec["exact"]:
    res = bc.solve(graphs[g], bc.BCQuery(mode="exact", n_b=nb),
                   mesh=meshes[m])
    out[f"exact_{g}_{m}_{nb}"] = res.lam
for i, (g, m, nb, src) in enumerate(spec["moments"]):
    run, nb_pad = prepare_mesh_batch_step(graphs[g], meshes[m], nb=nb,
                                          moments=True)
    s = np.zeros(nb_pad, np.int32)
    v = np.zeros(nb_pad, bool)
    s[:len(src)], v[:len(src)] = src, True
    for j, x in enumerate(run(s, v)):
        out[f"moments_{i}_{j}"] = x
for i, (g, m, src, sid, n_slots) in enumerate(spec["segmented"]):
    pl = bc.BCPlanner(calibration=None).plan(
        graphs[g], bc.BCQuery(mode="approx", eps=0.1, delta=0.1, n_b=32),
        mesh=meshes[m])
    ex = MeshExecutor(graphs[g], pl, mesh=meshes[m])
    for j, x in enumerate(ex.step_segmented(
            np.asarray(src, np.int32), np.ones(len(src), bool),
            np.asarray(sid, np.int32), n_slots)):
        out[f"segmented_{i}_{j}"] = x
    plans[f"buckets_{i}"] = [ex.n_b, list(ex.buckets)]
for m, mesh in meshes.items():
    for kind in ("exact", "approx"):
        q = (bc.BCQuery(mode="exact", n_b=16) if kind == "exact" else
             bc.BCQuery(mode="approx", eps=0.1, delta=0.1, n_b=16))
        plans[f"plan_{m}_{kind}"] = bc.BCPlanner(calibration=None).plan(
            graphs["g1"], q, mesh=mesh).to_json()
np.savez(spec["out"] + ".npz", **out)
with open(spec["out"] + ".json", "w") as f:
    json.dump(plans, f)
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """(port results by rank, reference arrays, reference plans): the
    8-rank world and the reference subprocess run side by side."""
    base = str(tmp_path_factory.mktemp("ref") / "ref")
    spec = {"out": base, "graphs": GRAPHS, "meshes": MESHES,
            "exact": EXACT,
            "moments": [(g, m, nb, s.tolist())
                        for g, m, nb, s in _moments_cases()],
            "segmented": [(g, m, s.tolist(), sid.tolist(), k)
                          for g, m, s, sid, k in _segmented_cases()]}
    proc = run_reference(_REFERENCE, spec)
    try:
        got = run_world(_world_main, WORLD)
    finally:
        finish_reference(proc)
    with open(base + ".json") as f:
        plans = json.load(f)
    return got, dict(np.load(base + ".npz")), plans


def _close(a, b):
    np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("case", EXACT, ids=lambda c: "-".join(map(str, c)))
def test_mesh_exact_matches_brandes_and_reference(world, case):
    got, ref, _ = world
    g, m, nb = case
    lam = got[0][("exact", g, m, nb)]
    _close(lam, brandes_bc(_graph(g)))
    _close(lam, ref[f"exact_{g}_{m}_{nb}"])
    for r in range(1, WORLD):  # every rank holds the same λ
        np.testing.assert_array_equal(got[r][("exact", g, m, nb)], lam)


@pytest.mark.parametrize("i", range(5))
def test_mesh_moments_match_single_host_and_reference(world, i):
    from repro.core import dense_adj_from_graph as jax_dense_adj
    from repro.core.mfbc import mfbc_batch_moments as jax_moments
    import jax.numpy as jnp

    got, ref, _ = world
    g, m, nb, src = _moments_cases()[i]
    s1, s2, nr = got[0][("moments", i)]
    r1, r2, rn = jax_moments(jax_dense_adj(_graph(g)), jnp.asarray(src),
                             jnp.ones(src.shape[0], bool))
    _close(s1, np.asarray(r1, np.float64))
    _close(s2, np.asarray(r2, np.float64))
    np.testing.assert_array_equal(nr, np.asarray(rn))
    _close(s1, ref[f"moments_{i}_0"])
    _close(s2, ref[f"moments_{i}_1"])
    np.testing.assert_array_equal(nr, ref[f"moments_{i}_2"])
    # the port's single host, on the same sources
    pl = tbc.plan(_graph(g), tbc.BCQuery(mode="approx", n_b=nb,
                                         execution=tbc.ExecutionConfig(
                                             backend="dense")),
                  n_devices=1, device="cpu")
    h1, h2, hn = tbc.build_executor(_graph(g), pl, device="cpu").step(
        src, np.ones(src.shape[0], bool))
    _close(s1, h1)
    _close(s2, h2)
    np.testing.assert_array_equal(nr, hn)


@pytest.mark.parametrize("i", range(5))
def test_mesh_moments_identical_on_every_rank(world, i):
    """``solve``'s epoch loop runs on every rank: its stopping decisions
    must not differ, so neither may the moments."""
    got, _, _ = world
    for r in range(1, WORLD):
        for a, b in zip(got[r][("moments", i)], got[0][("moments", i)]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("i", range(2))
def test_mesh_segmented_matches_reference(world, i):
    got, ref, plans = world
    g, m, src, sid, n_slots = _segmented_cases()[i]
    out = got[0][("segmented", i)]
    for j in range(3):
        _close(out[j], ref[f"segmented_{i}_{j}"])
        for r in range(1, WORLD):
            np.testing.assert_array_equal(got[r][("segmented", i)][j],
                                          out[j])
    n_b, buckets = got[0][("buckets", i)]
    assert [n_b, list(buckets)] == plans[f"buckets_{i}"]
    # the port's single host, on the same fused batch
    pl = tbc.plan(_graph(g), tbc.BCQuery(mode="approx", n_b=32,
                                         execution=tbc.ExecutionConfig(
                                             backend="dense")),
                  n_devices=1, device="cpu")
    host = tbc.build_executor(_graph(g), pl, device="cpu").step_segmented(
        src, np.ones(src.shape[0], bool), sid, n_slots)
    for a, b in zip(out, host):
        assert a.shape == (n_slots, _graph(g).n)
        _close(a, b)


@pytest.mark.parametrize("m", sorted(MESHES))
@pytest.mark.parametrize("kind", ["exact", "approx"])
def test_mesh_plan_json_equals_reference(world, m, kind):
    got, _, plans = world
    assert json.dumps(got[0][("plan", m, kind)], sort_keys=True) == \
        json.dumps(plans[f"plan_{m}_{kind}"], sort_keys=True)


def _closed_form(m, sweeps, n_pad, nb=16):
    """The bytes one moments batch hands the collectives, per rank, from
    the shapes: per multpath relax, the frontier gather (w, m), the
    extremum and tie-sum reduces and the re-gather (w, m); per centpath
    relax (the child count included), the gather (w, p), the extremum and
    the (p, c) tie sum, the re-gather (w, p, c); per batch the (3, n/M)
    sum and the (3, n) gather; one int per stop test."""
    shape, names = MESHES[m]
    s = dict(zip(names, shape))
    P, D, Mo = s.get("pod", 1), s["data"], s["model"]
    rows = nb // P  # the pod-local rows a relax gathers
    n_mp, n_cp, n_stop = sweeps
    col_m, col_d = rows * n_pad // Mo * 4, rows * n_pad // D * 4
    return {"gather": n_mp * 4 * col_m + n_cp * 5 * col_m,
            "extremum": (n_mp + n_cp) * col_d,
            "tie_sum": n_mp * col_d + n_cp * 2 * col_d,
            "batch": 3 * n_pad // Mo * 4 + 3 * n_pad * 4,
            "stop": 4 * n_stop}


@pytest.mark.parametrize("m", sorted(MESHES))
def test_comm_bytes_match_the_closed_form(world, m):
    got, _, _ = world
    counted, sweeps, n_pad = got[0][("bytes", m)]
    assert set(counted) == set(KINDS)
    assert counted == _closed_form(m, sweeps, n_pad)
    # a whole-world stop: every rank ran the same sweeps
    assert all(got[r][("bytes", m)][1] == sweeps for r in range(WORLD))
    # the model counts 3 state passes per relax; the port moves 2 to 8/3
    # of them (fields and the second reduce) when D = M
    shape, names = MESHES[m]
    model = model_mesh_bytes(n_pad, 16, (sweeps[0] + sweeps[1]) / 2,
                             dict(zip(names, shape)))
    relax = counted["gather"] + counted["extremum"] + counted["tie_sum"]
    assert 1.0 < relax / model < 4.0


@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("name", SEMIRINGS)
def test_spgemm_variant_matches_reference(world, variant, name):
    """Every rank's block of every variant against the reference's
    single-device product, cut to that block."""
    import jax.numpy as jnp
    from repro.core import monoids as jm

    got, _, _ = world
    fields, b = _spgemm_inputs()[name]
    if name == "arith":
        want = (fields[0].astype(np.float64) @ b.astype(np.float64),)
    elif name == "multpath":
        r = jm.multpath_relax_dense(jm.Multpath(*map(jnp.asarray, fields)),
                                    jnp.asarray(b))
        want = (np.asarray(r.w), np.asarray(r.m))
    else:
        r = jm.centpath_relax_dense(
            jm.Centpath(jnp.asarray(fields[0]), jnp.asarray(fields[1]),
                        jnp.asarray((fields[1] > 0).astype(np.float32))),
            jnp.asarray(b))
        want = (np.asarray(r.w), np.asarray(r.p), np.asarray(r.c))
    shape, names = SPGEMM_MESHES[variant[0]]
    spec_c = plan_specs(Plan(variant, names))[2]
    for rank in range(WORLD):
        blk = got[rank][("spgemm", variant, name)]
        blk = blk if isinstance(blk, tuple) else (blk,)
        where = _block_index(spec_c, shape, names, rank, want[0].shape)
        for field, x, y in zip(("w", "m" if name == "multpath" else "p",
                                "c"), blk, want):
            y = y[where]
            if name == "arith":
                np.testing.assert_allclose(x, y, rtol=1e-5, atol=1e-5)
            elif field in ("w", "c"):
                np.testing.assert_array_equal(x, y)
            else:
                np.testing.assert_allclose(
                    x, y, rtol=1e-6 if field == "m" else 1e-5)


def _block_index(spec, shape, names, rank, full):
    coords = np.unravel_index(rank, shape)
    idx = []
    for dim, entry in enumerate(spec):
        axes = (() if entry is None else (entry,) if isinstance(entry, str)
                else tuple(entry))
        k, cnt = 0, 1
        for a in axes:
            i = names.index(a)
            k, cnt = k * shape[i] + int(coords[i]), cnt * shape[i]
        blk = full[dim] // cnt
        idx.append(slice(k * blk, (k + 1) * blk))
    return tuple(idx)


# -- one rank, in process -------------------------------------------------------
@pytest.fixture
def one_rank():
    """A one-rank gloo world for the duration of a test."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield Mesh((1, 1), ("data", "model"), device="cpu")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def small_rmat():
    g = tgen.rmat(7, 8, seed=5).remove_isolated()[0]
    return g, brandes_bc(g)


@pytest.mark.parametrize("spec", ["2x4", "2x2x2", "1x1", "8", "2x0",
                                  "axb", "1x2x3x4"])
def test_parse_mesh_spec_matches_reference(spec):
    from repro.launch.mesh import parse_mesh_spec as ref_parse

    try:
        want = ref_parse(spec)
    except ValueError as e:
        with pytest.raises(ValueError) as err:
            parse_mesh_spec(spec)
        assert str(err.value) == str(e)
        return
    assert parse_mesh_spec(spec) == want


def test_mesh_needs_a_world_of_its_size(monkeypatch, one_rank):
    with pytest.raises(ValueError, match="needs 4 ranks"):
        mesh_from_spec("2x2", device="cpu")
    with pytest.raises(ValueError, match="needs 8 ranks"):
        make_debug_mesh(device="cpu")
    with monkeypatch.context() as mp:
        mp.setattr(dist, "is_initialized", lambda: False)
        with pytest.raises(RuntimeError, match="init_process_group"):
            Mesh((1, 1), ("data", "model"), device="cpu")


def test_one_rank_mesh_axes_and_groups(one_rank):
    mesh = mesh_from_spec("1x1x1", device="cpu")
    assert mesh.axis_sizes == {"pod": 1, "data": 1, "model": 1}
    assert mesh.index(("pod", "data")) == 0 and mesh.size("model") == 1
    assert mesh.device == torch.device("cpu") and mesh.backend == "gloo"
    with pytest.raises(ValueError, match="no process group"):
        mesh.group(("data", "model"))


def test_single_device_mesh_path(small_rmat, one_rank):
    """The distributed epoch path on a 1x1 mesh equals the estimator run
    (mirror of the reference's ``test_single_device_mesh_path``)."""
    g, lam_ref = small_rmat
    res = tbc.solve(g, tbc.BCQuery(mode="approx", eps=0.1, delta=0.2,
                                   iters=32, strategy="uniform",
                                   max_samples=200, seed=0),
                    mesh=one_rank).approx
    assert res.n_samples == 200
    top_ref = set(np.argsort(lam_ref)[::-1][:5].tolist())
    assert len(top_ref & set(res.topk(5).tolist())) >= 4


def test_mesh_moments_bitwise_single_host(small_rmat, one_rank):
    """(Σδ, Σδ², n_reach) of the 1x1 mesh step are bitwise the single-host
    executor's, and within rtol 1e-5 of the reference's 1x1 mesh step."""
    import jax
    from jax.sharding import Mesh as JaxMesh
    from repro.core.dist_bc import prepare_mesh_batch_step as ref_prepare

    g, _ = small_rmat
    run, nb_pad = prepare_mesh_batch_step(g, one_rank, nb=16, iters=32,
                                          moments=True)
    rng = np.random.default_rng(3)
    src = rng.integers(0, g.n, nb_pad).astype(np.int32)
    val = np.ones(nb_pad, bool)
    s1, s2, nr = run(src, val)
    pl = tbc.plan(g, tbc.BCQuery(mode="approx", n_b=16,
                                 execution=tbc.ExecutionConfig(
                                     backend="dense")),
                  n_devices=1, device="cpu")
    h1, h2, hn = tbc.build_executor(g, pl, device="cpu").step(src, val)
    np.testing.assert_array_equal(s1, h1)
    np.testing.assert_array_equal(s2, h2)
    np.testing.assert_array_equal(nr, hn)
    jmesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    r1, r2, rn = ref_prepare(g, jmesh, nb=16, iters=32, moments=True)[0](
        src, val)
    _close(s1, r1)
    _close(s2, r2)
    np.testing.assert_array_equal(nr, rn)


def test_mesh_adaptive_stops_before_hoeffding_on_star(one_rank):
    """Mesh epochs stop adaptively, not at the budget (mirror)."""
    from repro_torch.approx.sampling import hoeffding_budget

    g = tgen.star_graph(128)
    eps, delta = 0.05, 0.1
    res = tbc.solve(g, tbc.BCQuery(mode="approx", eps=eps, delta=delta,
                                   rule="bernstein", n_b=64, iters=8,
                                   seed=0), mesh=one_rank).approx
    assert res.converged
    assert res.n_samples < hoeffding_budget(g.n, eps, delta)
    assert int(res.topk(1)[0]) == 0


def test_exact_solve_mesh_matches_oracle(small_rmat, one_rank):
    g, ref = small_rmat
    res = tbc.solve(g, tbc.BCQuery(mode="exact", n_b=16, iters=32),
                    mesh=one_rank)
    _close(res.lam, ref)
    assert res.plan.placement == "mesh"
    assert res.plan.axes_dict() == {"data": 1, "model": 1}


def test_mesh_segmented_bitwise_single_host(small_rmat, one_rank):
    g, _ = small_rmat
    q = tbc.BCQuery(mode="approx", n_b=32,
                    execution=tbc.ExecutionConfig(backend="dense"))
    mesh_ex = tbc.build_executor(g, tbc.plan(g, q, mesh=one_rank),
                                 mesh=one_rank)
    host_ex = tbc.build_executor(g, tbc.plan(g, q, n_devices=1,
                                             device="cpu"), device="cpu")
    assert isinstance(mesh_ex, tbc.MeshExecutor)
    assert mesh_ex.buckets == host_ex.buckets
    rng = np.random.default_rng(4)
    src = rng.integers(0, g.n, 19).astype(np.int32)
    sid = rng.integers(0, 3, 19).astype(np.int32)
    for a, b in zip(mesh_ex.step_segmented(src, np.ones(19, bool), sid, 3),
                    host_ex.step_segmented(src, np.ones(19, bool), sid, 3)):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(mesh_ex.step_sum(src, np.ones(19, bool)),
                                  host_ex.step_sum(src, np.ones(19, bool)))


def test_plan_json_mesh_1x1_equals_reference(small_rmat, one_rank):
    import jax
    from jax.sharding import Mesh as JaxMesh
    import repro.bc as jbc

    g, _ = small_rmat
    jmesh = JaxMesh(np.array(jax.devices()[:1]).reshape(1, 1),
                    ("data", "model"))
    for kind in ("exact", "approx"):
        q = _query(kind, 16)
        jq = (jbc.BCQuery(mode="exact", n_b=16) if kind == "exact" else
              jbc.BCQuery(mode="approx", eps=0.1, delta=0.1, n_b=16))
        a = tbc.BCPlanner(calibration=None).plan(g, q, mesh=one_rank)
        b = jbc.BCPlanner(calibration=None).plan(g, jq, mesh=jmesh)
        assert json.dumps(a.to_json(), sort_keys=True) == \
            json.dumps(b.to_json(), sort_keys=True)
    with pytest.raises(ValueError, match="betweenness-only"):
        tbc.plan(g, tbc.BCQuery(metric="closeness"), mesh=one_rank)


def test_sweeps_stop_on_the_whole_world_empty_frontier(small_rmat,
                                                       one_rank):
    """The port stops each sweep when its frontier is empty on every rank;
    the reference runs ``iters`` (graph size) static iterations. The
    values agree: the skipped iterations change nothing."""
    g, _ = small_rmat
    ctx = MeshBCContext(g, one_rank)
    assert ctx.iters == g.n
    src = np.arange(16, dtype=np.int32)
    lam = ctx.run_sum(src, np.ones(16, bool), nb=16)
    n_mp, n_cp, n_stop = ctx.sweeps
    assert n_mp < g.n and n_cp < g.n
    assert n_stop == (n_mp - 1) + (n_cp - 1) + 2  # one failed test a sweep
    bounded = MeshBCContext(g, one_rank, iters=max(n_mp, n_cp) - 1)
    np.testing.assert_array_equal(
        bounded.run_sum(src, np.ones(16, bool), nb=16), lam)
    _close(lam, brandes_bc(g, sources=src))


@pytest.mark.parametrize("n,d,m", [(12, 2, 2), (16, 4, 2), (24, 2, 3),
                                   (40, 2, 2), (7, 1, 1), (36, 3, 4)])
def test_vertex_row_permutation_bitwise(n, d, m):
    from repro.core.dist_bc import vertex_row_permutation as ref_perm

    got = vertex_row_permutation(n, d, m)
    want = ref_perm(n, d, m)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("axes", [{"data": 2, "model": 2},
                                  {"pod": 2, "data": 2, "model": 2},
                                  {"data": 4, "model": 2},
                                  {"data": 1, "model": 1},
                                  {"pod": 2, "data": 1, "model": 2}])
def test_model_mesh_bytes_equals_benchmark(axes):
    sys.path.insert(0, REPO)
    try:
        from benchmarks.comm_cost import model_mesh_bytes as bench
    finally:
        sys.path.remove(REPO)
    for n, nb, iters in ((12536, 64, 40), (3342, 3344, 30), (40, 16, 7)):
        assert model_mesh_bytes(n, nb, iters, axes) == \
            bench(n, nb, iters, axes)


@pytest.mark.parametrize("shape,names", [((2, 2, 2), ("pod", "data", "model")),
                                         ((4, 2), ("data", "model")),
                                         ((2, 1, 2), ("pod", "data", "model"))])
@pytest.mark.parametrize("n_b", [16, 20, 64])
def test_mesh_executor_buckets_match_reference(small_rmat, shape, names,
                                               n_b):
    """Buckets rounded to pod·data, as the reference's ``MeshExecutor``
    (which only reads the mesh's axes before its first batch)."""
    from repro.bc.executor import MeshExecutor as RefMeshExecutor
    import repro.bc as jbc

    g, _ = small_rmat
    axes = dict(zip(names, shape))
    q = tbc.BCQuery(mode="approx", n_b=n_b)
    pl = tbc.BCPlanner(calibration=None).plan(g, q, n_devices=8)
    pl = tbc.BCPlan.from_json({**pl.to_json(),
                               "mesh_axes": axes, "placement": "mesh"})
    ours = tbc.MeshExecutor(g, pl, mesh=SimpleNamespace(axis_sizes=axes))
    ref = RefMeshExecutor(g, jbc.BCPlan.from_json(pl.to_json()),
                          mesh=SimpleNamespace(axis_names=names,
                                               devices=np.empty(shape)))
    assert (ours.n_b, ours.buckets) == (ref.n_b, ref.buckets)


# -- the CLI under torchrun --------------------------------------------------------
def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_bc_run_mesh_under_torchrun():
    """``torchrun --nproc-per-node 4 -m repro_torch.launch.bc_run --mesh
    2x2 --approx 0.1,0.1 --dist-backend gloo --device cpu``: every rank
    runs it, rank 0 prints once, and the answer passes ``--verify``."""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"),
               OMP_NUM_THREADS="1")
    cmd = [sys.executable, "-m", "torch.distributed.run",
           "--nproc-per-node", "4", "--master-addr", "127.0.0.1",
           "--master-port", str(_free_port()),
           "-m", "repro_torch.launch.bc_run", "--mesh", "2x2",
           "--approx", "0.1,0.1", "--dist-backend", "gloo", "--device",
           "cpu", "--scale", "5", "--nb", "16", "--verify"]
    out = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=TIMEOUT_S, cwd=REPO)
    assert out.returncode == 0, out.stdout + out.stderr
    assert out.stdout.count("[bc] graph") == 1  # rank 0 alone prints
    assert "mesh {'data': 2, 'model': 2} over 4 ranks, backend gloo" \
        in out.stdout
    assert "BCPlan[approx] mesh{'data': 2, 'model': 2} backend=dense" \
        in out.stdout
    assert "vs Brandes oracle" in out.stdout
    assert "WARNING" not in out.stdout


@pytest.mark.parametrize("argv,why", [
    (["--mesh", "2x2", "--approx", "0.1,0.1"], r"--dist-backend nccl\|gloo"),
    (["--mesh", "2x2"], "requires --approx"),
    (["--mesh", "2y2", "--approx", "0.1,0.1", "--dist-backend", "gloo"],
     "mesh spec expects"),
])
def test_bc_run_mesh_names_what_it_needs(argv, why):
    """The process-group backend is explicit: no default picks one from
    what the host has."""
    from repro_torch.launch import bc_run

    with pytest.raises(SystemExit, match=why):
        bc_run.main(["--scale", "3", "--device", "cpu"] + argv)
