"""The paper's own architecture in the port (``configs.base.BCArch``,
``mfbc_paper``) against the reference's.

* The cells (full and smoke) equal the reference's, field for field.
* Each smoke cell's one-device step (``mfbc_batch`` over
  ``DenseAdj(a, block=256)``, ``fori`` at the cell's iterations) on the
  reference's concrete arguments gives the reference's λ within rtol
  1e-5, atol 1e-8, and passes the reference's check (finite, ≥ -1e-6).
* The port's own concrete A, built from the arcs on the device, equals
  the reference's host ``coo_to_dense`` bitwise.
* The mesh branch: the Theorem 5.1 step at the cell's fixed iteration
  count (no stop test) on a one-rank gloo (1, 1, 1) mesh gives the
  one-device λ; its abstract arguments are the rank's blocks.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import base, get_arch

SMOKE = list(base.BC_SMOKE_CELLS)


def test_cells_match_reference():
    from repro.configs import base as jbase

    for ours, theirs in ((base.BC_CELLS, jbase.BC_CELLS),
                         (base.BC_SMOKE_CELLS, jbase.BC_SMOKE_CELLS)):
        assert {k: dataclasses.asdict(v) for k, v in ours.items()} == \
            {k: dataclasses.asdict(v) for k, v in theirs.items()}
    spec = get_arch("mfbc_paper")
    assert spec.family == "bc" and list(spec.cells()) == list(base.BC_CELLS)
    for smoke in (False, True):
        assert spec.config(smoke) == {"use_kernel": not smoke}


def _reference(shape_id: str):
    import jax

    from repro.configs import get_arch as jget_arch

    spec = jget_arch("mfbc_paper")
    b = spec.build(spec.cells()[shape_id], smoke=True)
    args = b.concrete_args(jax.random.key(0))
    lam = b.fn(*args)
    b.check(lam)
    return [np.asarray(a) for a in args], np.asarray(lam), b


@pytest.mark.parametrize("shape_id", SMOKE)
def test_smoke_cell_lambda_matches_reference(shape_id):
    (a, src, val), want, jb = _reference(shape_id)
    spec = get_arch("mfbc_paper")
    b = spec.build(spec.cells()[shape_id], smoke=True)
    assert b.trip_counts == jb.trip_counts
    assert b.model_flops == jb.model_flops
    lam = b.fn(*(torch.from_numpy(np.array(x)) for x in (a, src, val)))
    b.check(lam)
    np.testing.assert_allclose(lam.numpy(), want, rtol=1e-5, atol=1e-8)
    # the port's own arguments: A built from the arcs, bitwise the
    # reference's host dense array
    ours = b.concrete_args(None, "cpu")
    np.testing.assert_array_equal(ours[0].numpy(), a)
    np.testing.assert_array_equal(ours[1].numpy(), src)
    np.testing.assert_array_equal(ours[2].numpy(), val)
    assert len(b.concrete_args(None, "cpu", nb=3)[1]) == 3


@pytest.mark.parametrize("shape_id", SMOKE)
def test_mesh_branch_on_one_rank(shape_id):
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.sharding.rules import make_policy

    spec = get_arch("mfbc_paper")
    cell = spec.cells()[shape_id]
    single = spec.build(cell, smoke=True)
    a, src, val = single.concrete_args(None, "cpu")
    want = single.fn(a, src, val)
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        mesh = make_device_mesh((1, 1, 1), ("pod", "data", "model"),
                                device_type="cpu")
        b = spec.build(cell, make_policy(mesh), smoke=True)
        assert b.trip_counts == {}
        with FakeTensorMode():
            shapes = [tuple(t.shape) for t in b.abstract_args()]
        n, nb = a.shape[0], src.shape[0]
        assert shapes == [(n, n), (n, n), (nb,), (nb,)]
        got = b.fn(a, a.T.contiguous(), src, val)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-8)
