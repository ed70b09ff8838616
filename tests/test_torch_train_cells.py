"""The LM ``train_4k`` smoke cells of the port against the reference's.

``LMArch.build(train_4k, smoke=True).fn`` of each of the five
architectures on the reference bundle's concrete arguments (weights and
f32 moments carried by ``state_from_reference``): one AdamW step of the
train cell's optimizer (lr 3e-4 after 100 warm-up steps, so 3e-6 on step
0). Held: the loss (rtol 1e-6), ``lr`` (rtol 1e-6), the grad norm (rtol
1e-4), ``m`` — 0.1 × the clipped gradient — within 5e-4 of each leaf's
largest magnitude (``tests/test_torch_train.py``'s gemma2 gradient
tolerance; 2.8e-4 measured on gemma2-smoke, 1.3e-4 on the others), and
each leaf's update along the reference's (cosine ≥ 0.999, norm within
1 %; measured ≥ 0.99991, within 0.011 %); the model FLOPs and trip
counts equal the reference's.
"""
import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro_torch.configs import get_arch
from repro_torch import tree as tree_lib
from repro_torch.train.train_lib import state_from_reference, state_to_numpy

from test_torch_lm import LM_IDS, port_cfg


@pytest.mark.parametrize("arch", LM_IDS)
def test_train_smoke_cell_matches_reference(arch):
    jspec, spec = jget_arch(arch), get_arch(arch)
    jb = jspec.build(jspec.cells()["train_4k"], smoke=True)
    tb = spec.build(spec.cells()["train_4k"], smoke=True)
    assert tb.trip_counts == jb.trip_counts
    assert tb.model_flops == jb.model_flops
    args = jb.concrete_args(jax.random.key(42))
    before = jax.tree.map(np.asarray, {"params": args[0], "opt": args[1]})
    jp, jopt, jm = jax.jit(jb.fn)(*args)
    state = state_from_reference(port_cfg(jspec.config(smoke=True)), before,
                                 "cpu")
    toks = [torch.tensor(np.asarray(a), dtype=torch.long) for a in args[2:]]
    out = tb.fn(state["params"], state["opt"], *toks)
    tb.check(out)
    params, opt, m = out
    assert params is state["params"] and opt is state["opt"]  # in place
    for k, rtol in (("loss", 1e-6), ("lr", 1e-6), ("grad_norm", 1e-4)):
        np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=rtol,
                                   err_msg=k)
    assert int(opt["step"]) == int(jopt["step"]) == 1
    got = state_to_numpy({"params": params, "m": opt["m"]})
    want = jax.tree.map(np.asarray, {"params": jp, "m": jopt["m"]})
    old = dict(tree_lib.leaves(before["params"]))
    for (p, a), (_, b) in zip(tree_lib.leaves(got["m"]),
                              tree_lib.leaves(want["m"])):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=5e-4 * float(np.abs(b).max()),
                                   err_msg=f"m {p}")
    for (p, a), (_, b) in zip(tree_lib.leaves(got["params"]),
                              tree_lib.leaves(want["params"])):
        du = a.astype(np.float64) - old[p]
        dw = b.astype(np.float64) - old[p]
        cos = float(du.ravel() @ dw.ravel()) / (np.linalg.norm(du)
                                               * np.linalg.norm(dw))
        ratio = np.linalg.norm(du) / np.linalg.norm(dw)
        assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (p, cos, ratio)
