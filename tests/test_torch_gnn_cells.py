"""The GNN and recsys smoke cells of the port against the reference's.

Each of the 20 cells (four GNNs × four shapes, xDeepFM × four) through
``build(cell, smoke=True).fn`` of both packages, on the reference
bundle's concrete arguments: the weights carried by
``params_from_reference``, the batch from ``GNNArch.numpy_batch`` /
``RecsysArch.numpy_args``, which must equal the reference's numpy draws
bitwise. A train cell takes one AdamW step (lr 3e-6 on step 0): the loss
within rtol 1e-5, the grad norm within rtol 1e-4, ``m`` (0.1 × the
clipped gradient) within 1e-4 of each leaf's largest magnitude (the
gradient tolerance of ``tests/test_torch_gnn.py``), and each leaf's
update along the reference's (cosine ≥ 0.999, norm within 1 %; a leaf
with a zero gradient in both stays put). A serve or retrieval cell's
outputs are held within 1e-4 of their largest magnitude. The model
FLOPs equal the reference's; the port's own ``concrete_args`` run and
pass the cell's check.

Also: ``examples/gnn_train.py``'s two loops mirrored by
``examples/torch_gnn_train.py`` (the first 8 losses within rtol 1e-4 of
the reference's, from the same initial parameters; the example's own
assertion that the loss falls, on both), and the
tree walk over list-holding trees in ``jax.tree.leaves``' order.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.configs import get_arch as jget_arch
from repro.models import gnn as JG
from repro.optim import adamw as jadamw
from repro.train.train_lib import make_generic_train_step as jgeneric
from repro_torch import tree as tree_lib
from repro_torch.configs import all_cells, base, get_arch
from repro_torch.configs.base import batch_to_torch
from repro_torch.launch import serve as launch_serve
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn as G
from repro_torch.optim import adamw

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "examples"))
import torch_gnn_train as TGT  # noqa: E402

GNN_IDS = ("gcn-cora", "gin-tu", "nequip", "gat-cora")
CELLS = ([(a, s) for a in GNN_IDS for s in jbase.GNN_CELLS]
         + [("xdeepfm", s) for s in jbase.RECSYS_CELLS])
HELD_STEPS = 8


def close_to_scale(got, want, tol: float = 1e-4, what: str = "") -> None:
    want = np.asarray(want)
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


def test_cells_and_registry_match_reference():
    assert {k: v.__dict__ for k, v in base.GNN_CELLS.items()} == \
        {k: v.__dict__ for k, v in jbase.GNN_CELLS.items()}
    assert base.GNN_SMOKE_META == jbase.GNN_SMOKE_META
    for ours, theirs in ((base.RECSYS_CELLS, jbase.RECSYS_CELLS),
                         (base.RECSYS_SMOKE_CELLS, jbase.RECSYS_SMOKE_CELLS)):
        assert {k: v.__dict__ for k, v in ours.items()} == \
            {k: v.__dict__ for k, v in theirs.items()}
    assert len(all_cells()) == 42  # with mfbc_paper's two (slice 7d)
    assert set(CELLS) <= set(all_cells())
    for a in GNN_IDS + ("xdeepfm",):
        for smoke in (False, True):
            ours, theirs = get_arch(a).config(smoke), jget_arch(a).config(smoke)
            assert ours.__dict__ == theirs.__dict__, (a, smoke)
        # the LM launchers refuse them, by name
        with pytest.raises(SystemExit, match="drives LM archs"):
            launch_serve.main(["--arch", a, "--smoke", "--device", "cpu"])
        with pytest.raises(AssertionError, match="drives LM archs"):
            launch_train.main(["--arch", a, "--smoke", "--device", "cpu"])


def _train_step_matches(tb, jb, args, port_args):
    """One step of both bundles from the same state: the module
    docstring's tolerances."""
    before = jax.tree.map(np.asarray, args[0])
    jp, jopt, jm = jax.jit(jb.fn)(*args)
    p = G.params_from_reference(before, "cpu")
    opt = adamw.init_state(p)
    out = tb.fn(p, opt, *port_args)
    tb.check(out)
    params, opt, m = out
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["lr"]), float(jm["lr"]), rtol=1e-6)
    assert int(opt["step"]) == int(jopt["step"]) == 1
    want_m = jax.tree.leaves(jopt["m"])
    old = dict(tree_lib.leaves(before))
    want_p = jax.tree.leaves(jp)
    for (path, a), b in zip(tree_lib.leaves(opt["m"]), want_m):
        b = np.asarray(b)
        if not b.any():
            assert not a.any(), path
            continue
        close_to_scale(a.numpy(), b, what=f"m {path}")
    for (path, a), b in zip(tree_lib.leaves(params), want_p):
        du = a.double().numpy() - old[path]
        dw = np.asarray(b, np.float64) - old[path]
        if not dw.any():
            assert not du.any(), path
            continue
        cos = float(du.ravel() @ dw.ravel()) / (np.linalg.norm(du)
                                               * np.linalg.norm(dw))
        ratio = np.linalg.norm(du) / np.linalg.norm(dw)
        assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (path, cos, ratio)


@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}::{s}" for a, s in CELLS])
def test_smoke_cell_matches_reference(arch, shape):
    jspec, spec = jget_arch(arch), get_arch(arch)
    jb = jspec.build(jspec.cells()[shape], smoke=True)
    tb = spec.build(spec.cells()[shape], smoke=True)
    assert tb.model_flops == jb.model_flops and tb.trip_counts == {}
    args = jb.concrete_args(jax.random.key(42))
    if arch != "xdeepfm":
        nb = spec.numpy_batch(shape, smoke=True)
        assert set(nb) == set(args[2])
        for k, v in nb.items():
            w = np.asarray(args[2][k])
            assert v.dtype == w.dtype and np.array_equal(v, w), k
        _train_step_matches(tb, jb, args, (batch_to_torch(nb, "cpu"),))
    else:
        ins = spec.numpy_args(shape, smoke=True)
        assert len(ins) == len(args) - (2 if shape == "train_batch" else 1)
        for a, w in zip(ins, args[-len(ins):]):
            w = np.asarray(w)
            assert a.dtype == w.dtype and np.array_equal(a, w)
        t_ins = [torch.from_numpy(a).long() if a.ndim == 3
                 else torch.from_numpy(a) for a in ins]
        if shape == "train_batch":
            _train_step_matches(tb, jb, args, t_ins)
        else:
            p = G.params_from_reference(jax.tree.map(np.asarray, args[0]),
                                        "cpu")
            got = tb.fn(p, *t_ins)
            tb.check(got)
            want = np.asarray(jax.jit(jb.fn)(*args))
            assert got.shape == want.shape
            close_to_scale(got.numpy(), want)
    # the port's own arguments, drawn from a generator, run and check
    own = tb.concrete_args(torch.Generator().manual_seed(0), "cpu")
    if arch != "xdeepfm":
        nb = batch_to_torch(spec.numpy_batch(shape, smoke=True), "cpu")
        assert {k: (v.shape, v.dtype) for k, v in own[2].items()} == \
            {k: (v.shape, v.dtype) for k, v in nb.items()}
    tb.check(tb.fn(*own))


def test_gcn_sampled_loop_matches_reference():
    """``examples/gnn_train.py``'s GCN loop: the first steps' losses."""
    cfg = JG.GCNConfig("gcn-sampled", d_in=16, d_hidden=16, n_classes=4)
    init_fn, step_fn = jgeneric(
        lambda p, b: JG.node_ce_loss("gcn", cfg, p, b),
        lambda k: JG.gcn_init(cfg, k), jadamw.AdamWConfig(lr=5e-3))
    state = init_fn(jax.random.key(0))
    p0 = G.params_from_reference(jax.tree.map(np.asarray, state["params"]),
                                 "cpu")
    want = []
    for b in TGT.gcn_batches(TGT.GCN_STEPS):
        state, m = step_fn(state, {k: jnp.asarray(v) for k, v in b.items()})
        want.append(float(m["loss"]))
    got = TGT.train_gcn_sampled("cpu", params=p0)
    np.testing.assert_allclose(got[:HELD_STEPS], want[:HELD_STEPS],
                               rtol=1e-4)
    # the example's own assertion, on both
    assert np.mean(want[-5:]) < want[0] and np.mean(got[-5:]) < got[0]


def test_nequip_loop_matches_reference():
    """``examples/gnn_train.py``'s NequIP loop on its fixed molecules."""
    cfg = JG.NequIPConfig("nequip-demo", n_layers=3, channels=16, d_in=8)
    mol, n_graphs = TGT.nequip_batch()
    assert n_graphs == 8 + 1  # the reference example's static count
    init_fn, step_fn = jgeneric(
        lambda p, b: JG.energy_mse_loss(cfg, p, dict(b, n_graphs=n_graphs)),
        lambda k: JG.nequip_init(cfg, k), jadamw.AdamWConfig(lr=2e-3))
    state = init_fn(jax.random.key(1))
    p0 = G.params_from_reference(jax.tree.map(np.asarray, state["params"]),
                                 "cpu")
    batch = {k: jnp.asarray(v) for k, v in mol.items()}
    want = []
    for _ in range(TGT.NEQUIP_STEPS):
        state, m = step_fn(state, batch)
        want.append(float(m["loss"]))
    got = TGT.train_nequip("cpu", params=p0)
    np.testing.assert_allclose(got[:HELD_STEPS], want[:HELD_STEPS],
                               rtol=1e-4)
    assert np.mean(want[-5:]) < np.mean(want[:5])
    assert np.mean(got[-5:]) < np.mean(got[:5])


def test_tree_walks_lists_in_jax_order():
    """A GIN and an xDeepFM tree (dicts holding lists) walk in
    ``jax.tree.leaves``' order; ``unflatten`` rebuilds the lists; AdamW
    updates such a tree in place, list slots included."""
    jp = jax.tree.map(np.asarray, JG.gin_init(
        JG.GINConfig("g", n_layers=3, d_in=4, d_hidden=5),
        jax.random.key(0)))
    pairs = tree_lib.leaves(jp)
    assert [id(a) for _, a in pairs] == [id(a) for a in jax.tree.leaves(jp)]
    assert pairs[0][0] == ("eps",) and pairs[1][0] == ("mlps", 0, "b1")
    back = tree_lib.unflatten(pairs)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    assert isinstance(back["mlps"], list) and len(back["mlps"]) == 3
    p = G.params_from_reference(jp, "cpu")
    state = adamw.init_state(p)
    grads = tree_lib.tree_map(torch.ones_like, p)
    leaves_before = [t for _, t in tree_lib.leaves(p)]
    adamw.update(adamw.AdamWConfig(), grads, state, p)
    assert [t for _, t in tree_lib.leaves(p)] == leaves_before  # in place
    assert all(t is None for _, t in tree_lib.leaves(grads))  # consumed
    assert all(not np.array_equal(t.numpy(), a)
               for (_, t), (_, a) in zip(tree_lib.leaves(p), pairs))
    # a tuple is walked as a list is; a shape stays a leaf where asked
    assert tree_lib.leaves({"a": (1, [2, 3])}) == [
        (("a", 0), 1), (("a", 1, 0), 2), (("a", 1, 1), 3)]
    assert tree_lib.leaves({"s": (2, 3)}, tree_lib.is_shape) == [
        (("s",), (2, 3))]
