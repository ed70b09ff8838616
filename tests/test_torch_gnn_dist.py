"""The port's 2D edge-partitioned GCN (``repro_torch.models.gnn_dist``)
against the single-device GCN of ``tests/md_gnn2d_check.py``.

* One spawned world of 8 gloo ranks on the CPU runs the (2, 2, 2)
  (pod, data, model) and (4, 2) (data, model) meshes: each rank's loss
  within rtol 1e-5 of the single-device loss (the reference's, under
  ``jax``), its gradients after ``sync_grads`` within rtol 2e-4, atol
  1e-6 of ``jax.grad``'s, every rank's equal to rank 0's; the bytes a
  rank hands the collectives in one forward equal |H|/R (the
  reduce-scatter, ``tie_sum``) + |H|/C (the all-gather, ``gather``) a
  layer, plus the two loss sums.
* ``bucket_edges`` and ``layout_features`` bitwise against the
  reference's on both grids, and the bucket-overflow raise of both.
* A one-rank gloo mesh (1 × 1) in process, held as the world's.

The module imports neither jax nor ``repro`` at the top: the spawned
ranks import it. The tests import the reference inside their bodies.
"""
import dataclasses
import datetime
import traceback
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.graphs.generators import erdos_renyi
from repro_torch.launch.mesh import Mesh
from repro_torch.models import gnn_dist as GD

from _torch_world import run_world

WORLD = 8
MESHES = {"2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "4x2": ((4, 2), ("data", "model"))}
N, D_IN, D_H, CLASSES = 37, 12, 16, 5


def problem():
    """``md_gnn2d_check.py``'s graph, features, labels and weights."""
    rng = np.random.default_rng(0)
    g = erdos_renyi(N, 0.15, seed=2)
    x = rng.normal(size=(N, D_IN)).astype(np.float32)
    labels = rng.integers(0, CLASSES, N).astype(np.int32)
    deg = np.bincount(g.dst, minlength=N).astype(np.float32)
    dinv = 1.0 / np.sqrt(np.maximum(deg, 1.0))
    coef = (dinv[g.src] * dinv[g.dst]).astype(np.float32)
    # (the check divides in f64 and hands jax the f32 rounding)
    w = [(rng.normal(size=(D_IN, D_H)).astype(np.float32)
          / np.sqrt(D_IN)).astype(np.float32),
         (rng.normal(size=(D_H, CLASSES)).astype(np.float32)
          / np.sqrt(D_H)).astype(np.float32)]
    return g, x, labels, coef, w


def run_mesh(mesh: Mesh) -> dict:
    """The 2D loss, its synced gradients and one forward's bytes on this
    rank."""
    g, x, labels, coef, w = problem()
    grid = GD.make_grid(mesh, N, g.nnz)
    src_b, dst_b, coef_b = GD.bucket_edges(grid, g.src, g.dst, coef)
    xp = GD.layout_features(grid, x)
    lp = GD.layout_features(grid, labels[:, None].astype(np.float32))[:, 0]
    mask = GD.layout_features(grid, np.ones((N, 1), np.float32))[:, 0] > 0
    args = GD.rank_inputs(mesh, grid, xp, src_b, dst_b, coef_b,
                          lp.astype(np.int32), mask)
    loss_fn = GD.build_gcn2d_loss(mesh, grid, n_layers=2)
    params = {"w": [torch.from_numpy(a).requires_grad_() for a in w]}
    mesh.reset_counts()
    with torch.no_grad():
        loss_fn(params, *args)
    fwd_bytes = dict(mesh.comm_bytes)
    loss = loss_fn(params, *args)
    grads = torch.autograd.grad(loss, params["w"])
    grads = GD.sync_grads(mesh, grid, list(grads))
    return {"loss": float(loss.detach()), "grads": [a.numpy() for a in grads],
            "bytes": fwd_bytes, "grid": (grid.n_pad, grid.R, grid.C)}


def _world_main(rank: int, store: str, results) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=120))
        out = {key: run_mesh(Mesh(shape, names, device="cpu"))
               for key, (shape, names) in MESHES.items()}
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def reference():
    """The single-device loss and gradients of ``md_gnn2d_check.py``."""
    import jax
    import jax.numpy as jnp

    g, x, labels, coef, w = problem()

    def ref_loss(params):
        h = jnp.asarray(x)
        for i, wi in enumerate(params["w"]):
            hw = h @ wi
            m = hw[jnp.asarray(g.src)] * jnp.asarray(coef)[:, None]
            h = jax.ops.segment_sum(m, jnp.asarray(g.dst), num_segments=N)
            if i == 0:
                h = jax.nn.relu(h)
        logz = jax.nn.logsumexp(h, axis=-1)
        gold = jnp.take_along_axis(h, jnp.asarray(labels)[:, None], 1)[:, 0]
        return jnp.mean(logz - gold)

    params = {"w": [jnp.asarray(a) for a in w]}
    loss, grads = jax.value_and_grad(ref_loss)(params)
    return float(loss), [np.asarray(a) for a in grads["w"]]


def held(out: dict, want) -> None:
    loss, grads = want
    np.testing.assert_allclose(out["loss"], loss, rtol=1e-5)
    for a, b in zip(out["grads"], grads):
        np.testing.assert_allclose(a, b, rtol=2e-4, atol=1e-6)


def model_bytes(out: dict) -> dict:
    """One forward's bytes a rank: per layer |H|/R reduced (the (N/R, h)
    partial) and |H|/C gathered (the (N/C, h) state), 4 B an entry; two
    4-byte scalar sums (loss and count)."""
    n_pad, R, C = out["grid"]
    return {"tie_sum": sum(4 * n_pad // R * h for h in (D_H, CLASSES)) + 8,
            "gather": sum(4 * n_pad // C * h for h in (D_H, CLASSES))}


def test_2d_gcn_on_8_ranks_matches_single_device():
    got = run_world(_world_main, WORLD)
    want = reference()
    for key in MESHES:
        for rank in range(WORLD):
            out = got[rank][key]
            held(out, want)
            assert out["loss"] == got[0][key]["loss"]
            for a, b in zip(out["grads"], got[0][key]["grads"]):
                np.testing.assert_array_equal(a, b)
            counted = {k: v for k, v in out["bytes"].items() if v}
            assert counted == model_bytes(out), (key, rank)


def test_one_rank_mesh_matches_single_device():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        out = run_mesh(Mesh((1, 1), ("data", "model"), device="cpu"))
    finally:
        dist.destroy_process_group()
    held(out, reference())
    assert {k: v for k, v in out["bytes"].items() if v} == model_bytes(out)


def _grids():
    """Each mesh's grid (``make_grid`` reads only the axis sizes) and the
    reference's of the same fields."""
    from repro.models import gnn_dist as JGD

    g = problem()[0]
    for shape, names in MESHES.values():
        grid = GD.make_grid(SimpleNamespace(axis_sizes=dict(zip(names,
                                                                shape))),
                            N, g.nnz)
        yield grid, JGD.Grid2D(**dataclasses.asdict(grid))


def test_bucketing_and_layout_match_reference_bitwise():
    from repro.models import gnn_dist as JGD

    g, x, _, coef, _ = problem()
    for grid, jgrid in _grids():
        for c in (coef, None):
            ours = GD.bucket_edges(grid, g.src, g.dst, c)
            theirs = JGD.bucket_edges(jgrid, g.src, g.dst, c)
            for a, b in zip(ours, theirs):
                assert a.dtype == b.dtype and np.array_equal(a, b)
        a, b = GD.layout_features(grid, x), JGD.layout_features(jgrid, x)
        assert a.dtype == b.dtype and np.array_equal(a, b)
        # every real vertex lands once, in its model shard's rows
        assert np.array_equal(np.sort(a[np.abs(a).sum(1) > 0], axis=0),
                              np.sort(x, axis=0))


def test_bucket_overflow_raises_in_both():
    from repro.models import gnn_dist as JGD

    g = problem()[0]
    grid, jgrid = next(_grids())
    small = GD.Grid2D(grid.n_pad, 4, grid.r_axes, "model", grid.R, grid.C)
    jsmall = JGD.Grid2D(grid.n_pad, 4, grid.r_axes, "model", grid.R, grid.C)
    with pytest.raises(ValueError, match="bucket overflow"):
        GD.bucket_edges(small, g.src, g.dst)
    with pytest.raises(ValueError, match="bucket overflow"):
        JGD.bucket_edges(jsmall, g.src, g.dst)
