"""LM training in the port against the reference, on carried states.

* ``loss_fn`` (plain CE and 4-chunk CE) and its gradient against
  ``jax.value_and_grad`` of ``repro.models.transformer.loss_fn`` on
  gemma2-smoke (sandwich norms, softcaps, window 16 < S), moonshot-smoke
  (MoE with capacity drops) and command-r-smoke (parallel block) at S = 32,
  weights carried from the reference. The loss within rtol 1e-6; each
  gradient leaf within ``GRAD_TOL`` of its largest magnitude: 1e-4, but
  5e-4 on gemma2-smoke, whose f32 gradient the reference itself computes
  only to 2.8e-4 of its scale (``tools/torch_grad_noise.py`` evaluates
  both against an f64 evaluation of the same model: the reference is off
  by up to 2.8e-4 of a leaf's scale there, the port by up to 3.5e-4).
* ``remat`` none / full / dots give bitwise equal losses and gradients,
  and the gradient reaches every leaf of a stacked tree; a call leaves
  nothing alive in a reference cycle.
* ``make_lm_train_step`` against the reference's over 3 steps from a state
  carried by ``state_from_reference`` (f32 and int8 moments, with and
  without int8 compression): run side by side, the losses within rtol
  1e-3 (with int8 compression a gradient element within the f32 noise of
  a quantization boundary moves by a whole quantum, max|g|/127, and the
  two runs drift: 5.6e-4 by step 3); and each step taken from the
  reference's own state at that step (identical inputs): the loss within
  rtol 1e-6, the grad norm within
  rtol 1e-3, ``step`` and ``wire_bytes`` equal, and each leaf's update
  (new minus old parameters) along the reference's: cosine ≥ 0.999, norm
  within 1 % (measured: ≥ 0.99972, within 0.14 %). Parameters after a step are not held elementwise: AdamW's
  first step moves each element by ±lr whatever its gradient's size, so
  the sign of a gradient element within the f32 noise moves it by 2·lr.
* ``state_from_reference`` / ``state_to_numpy`` round trips, bitwise; a
  checkpoint written by ``repro.train.checkpoint.save`` resumes in the
  port to the reference's next step, and one written by the port resumes
  in the reference.
* Mirrors of ``tests/test_fault_tolerance.py::test_restart_is_bit_exact``
  (rtol 1e-6) and of its ``test_pipeline_determinism``; a failure at step
  1, before the first save, ends equal to the clean run.
* ``LMPipeline``, ``RecsysPipeline``, ``GraphPipeline`` (molecule) and
  ``NeighborSampler`` streams bitwise the reference's.
* ``launch.train --smoke --device cpu``: the loss falls, and a run under
  ``--ckpt-dir`` with failures equals the clean one.
"""
import dataclasses
import functools
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.data import pipeline as JP
from repro.graphs import generators as JG
from repro.graphs import sampler as JS
from repro.models import transformer as JT
from repro.optim import adamw as JA
from repro.optim.grad_compress import CompressConfig as JCompress
from repro.train import checkpoint as jckpt
from repro.train.train_lib import make_lm_train_step as jmake
from repro_torch.data import pipeline as P
from repro_torch.graphs import generators as G
from repro_torch.graphs import sampler as S
from repro_torch.launch import train as launch_train
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch import tree as tree_lib
from repro_torch.optim.grad_compress import CompressConfig
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.fault import ChaosConfig, Supervisor
from repro_torch.train.train_lib import (make_lm_train_step,
                                         state_from_reference,
                                         state_to_numpy, value_and_grad)

from test_torch_lm import port_cfg, reference_params

REPO = Path(__file__).resolve().parents[1]
GRAD_TOL = {"gemma2-27b": 5e-4, "moonshot-v1-16b-a3b": 1e-4,
            "command-r-plus-104b": 1e-4}
B, SEQ = 2, 32


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch(vocab, seed=1):
    toks = np.random.default_rng(seed).integers(0, vocab, (B, SEQ + 1))
    toks = toks.astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _long(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a), dtype=torch.long)


def _scale_close(got, want, tol, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * float(np.abs(want).max()),
                               err_msg=what)


@functools.lru_cache(maxsize=None)
def _carried(arch):
    """The reference's smoke config, weights (numpy), one batch, and its
    jitted loss and gradient on them."""
    jcfg = jget_arch(arch).config(smoke=True)
    params = reference_params(jcfg, 0)
    x, y = _batch(jcfg.vocab)
    loss, grads = jax.jit(jax.value_and_grad(
        lambda p: JT.loss_fn(jcfg, p, x, y)))(params)
    return jcfg, _np_tree(params), (x, y), float(loss), _np_tree(grads)


def _port_params(arch):
    jcfg, params, _, _, _ = _carried(arch)
    cfg = port_cfg(jcfg)
    return cfg, state_from_reference(cfg, {"params": params}, "cpu")["params"]


# ---------------------------------------------------------------------------
# loss_fn and remat
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunks", [1, 4])
@pytest.mark.parametrize("arch", list(GRAD_TOL))
def test_loss_and_grads_match_reference(arch, chunks):
    _, _, (x, y), want_loss, want_grads = _carried(arch)
    cfg, params = _port_params(arch)
    loss, grads = value_and_grad(
        lambda p: T.loss_fn((cfg, p), _long(x), _long(y), chunks=chunks),
        params)
    np.testing.assert_allclose(float(loss), want_loss, rtol=1e-6)
    got, want = tree_lib.leaves(grads), tree_lib.leaves(want_grads)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        _scale_close(a.numpy(), b, GRAD_TOL[arch], "/".join(p))


def test_loss_of_a_module_equals_its_tree():
    """``loss_fn`` on a ``Transformer`` and on its stacked tree: one
    forward, bitwise."""
    arch = "gemma2-27b"
    jcfg, params, (x, y), _, _ = _carried(arch)
    cfg, tree = _port_params(arch)
    model = T.params_from_reference(cfg, params, "cpu")
    for chunks in (1, 4):
        a = T.loss_fn(model, _long(x), _long(y), chunks=chunks)
        b = T.loss_fn((cfg, tree), _long(x), _long(y), chunks=chunks)
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch", ["gemma2-27b", "moonshot-v1-16b-a3b"])
def test_remat_is_bitwise_and_reaches_every_leaf(arch):
    """The layers checkpointed whole (``full``) or keeping the products
    (``dots``) give the loss and every gradient of no remat, bitwise, and
    every leaf of the stacked tree gets a gradient."""
    _, _, (x, y), _, _ = _carried(arch)
    cfg, params = _port_params(arch)
    out = {}
    for remat in ("none", "full", "dots"):
        c = dataclasses.replace(cfg, remat=remat)
        out[remat] = value_and_grad(
            lambda p: T.loss_fn((c, p), _long(x), _long(y), chunks=4),
            params)
    loss, grads = out["none"]
    leaves = tree_lib.leaves(grads)
    assert len(leaves) == len(tree_lib.leaves(params))
    for p, g in leaves:
        assert bool((g != 0).any()), p
    for remat in ("full", "dots"):
        assert torch.equal(out[remat][0], loss), remat
        for (p, a), (_, b) in zip(tree_lib.leaves(out[remat][1]), leaves):
            assert torch.equal(a, b), (remat, p)
    assert not any(t.requires_grad for _, t in tree_lib.leaves(params))


_FIRST_CALL = """
import gc, dataclasses, torch
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T
from repro_torch.train.train_lib import value_and_grad
cfg = dataclasses.replace(get_arch("gemma2-27b").config(smoke=True),
                          remat="full")
toks = torch.randint(0, cfg.vocab, (1, 64))
def live():
    return sum(o.untyped_storage().nbytes() for o in gc.get_objects()
               if torch.is_tensor(o))
gc.disable()
base = live()
p = T.init_tree(cfg, torch.Generator().manual_seed(0), "cpu")
before = live()
left = []
for _ in range(3):
    loss, grads = value_and_grad(
        lambda q: T.loss_fn((cfg, q), toks, toks, chunks=8), p)
    del loss, grads
    left.append(live() - before)
del p
left.append(live() - base)
print(*left)
"""


def test_train_calls_leave_nothing_alive():
    """In a fresh interpreter with the automatic collector off, the
    memory of each remat call's graph and gradients, and at last the
    parameters, is free once the caller drops them: nothing is held by a
    reference cycle. (The first ``torch.utils.checkpoint`` call imports
    torch._dynamo, which leaves a cycle through the frames on the stack;
    ``value_and_grad`` collects it.)"""
    env = dict(os.environ, PYTHONPATH=str(REPO / "src"))
    out = subprocess.run([sys.executable, "-c", _FIRST_CALL], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["0"] * 4, out.stdout


# ---------------------------------------------------------------------------
# The train step
# ---------------------------------------------------------------------------

STEP_ARCH = "gemma2-27b"
STEP_CASES = [("f32", None), ("int8", None), ("f32", "int8"),
              ("int8", "int8")]


def _steps(md, comp):
    jcfg = jget_arch(STEP_ARCH).config(smoke=True)
    kw = dict(lr=1e-3, warmup_steps=2, total_steps=50, moment_dtype=md)
    jinit, jstep = jmake(jcfg, JA.AdamWConfig(**kw),
                         compress_cfg=JCompress(kind=comp) if comp else None)
    cfg = port_cfg(jcfg)
    _, step = make_lm_train_step(
        cfg, adamw.AdamWConfig(**kw),
        CompressConfig(kind=comp) if comp else None, device="cpu")
    return cfg, jinit, jstep, step


def _pipe(vocab):
    return P.LMPipeline(P.LMDataConfig(vocab=vocab, batch=B, seq=SEQ,
                                       seed=3))


def _params_np(state):
    return dict(tree_lib.leaves(state_to_numpy(state)["params"]))


@pytest.mark.parametrize("md,comp", STEP_CASES,
                         ids=[f"{m}-{c or 'none'}" for m, c in STEP_CASES])
def test_lm_train_step_matches_reference(md, comp):
    cfg, jinit, jstep, step = _steps(md, comp)
    js = jinit(jax.random.key(0))
    ts = state_from_reference(cfg, _np_tree(js), "cpu")
    pipe = _pipe(cfg.vocab)
    for k in range(3):
        batch = pipe.batch(k)
        # from the reference's own state at step k: identical inputs
        before = _np_tree(js)
        alone = state_from_reference(cfg, before, "cpu")
        js, jm = jstep(js, batch)
        alone, am = step(alone, batch)
        ts, tm = step(ts, batch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=1e-3, err_msg=f"step {k}")
        np.testing.assert_allclose(float(am["loss"]), float(jm["loss"]),
                                   rtol=1e-6, err_msg=f"step {k}")
        np.testing.assert_allclose(float(am["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-3)
        np.testing.assert_allclose(float(am["lr"]), float(jm["lr"]),
                                   rtol=1e-6)
        if comp:
            assert am["wire_bytes"] == tm["wire_bytes"] == int(
                jm["wire_bytes"])
        assert int(alone["opt"]["step"]) == int(js["opt"]["step"]) == k + 1
        old = dict(tree_lib.leaves(before["params"]))
        want = dict(tree_lib.leaves(_np_tree(js)["params"]))
        for p, got in _params_np(alone).items():
            du = got.astype(np.float64) - old[p]
            dw = want[p].astype(np.float64) - old[p]
            cos = float(du.ravel() @ dw.ravel()) / (
                np.linalg.norm(du) * np.linalg.norm(dw))
            ratio = np.linalg.norm(du) / np.linalg.norm(dw)
            assert cos >= 0.999 and abs(ratio - 1) <= 0.01, (k, p, cos, ratio)


@pytest.mark.parametrize("md,comp", [("f32", None), ("int8", "int8")],
                         ids=["f32-none", "int8-int8"])
def test_train_state_round_trips_bitwise(md, comp):
    cfg, jinit, jstep, step = _steps(md, comp)
    js, _ = jstep(jinit(jax.random.key(0)), _pipe(cfg.vocab).batch(0))
    ref = _np_tree(js)
    ts = state_from_reference(cfg, ref, "cpu")
    back = state_to_numpy(ts)
    got, want = tree_lib.leaves(back), tree_lib.leaves(ref)
    assert [p for p, _ in got] == [p for p, _ in want]
    for (p, a), (_, b) in zip(got, want):
        assert a.shape == b.shape and a.dtype.itemsize == b.dtype.itemsize
        assert a.tobytes() == b.tobytes(), p
    again = state_from_reference(cfg, back, "cpu")
    for (p, a), (_, b) in zip(tree_lib.leaves(again), tree_lib.leaves(ts)):
        assert a.dtype == b.dtype and torch.equal(a, b), p
    assert ts["opt"]["v"]["embedding"].dtype == (
        torch.bfloat16 if md == "int8" else torch.float32)
    with pytest.raises(ValueError, match="expected"):
        state_from_reference(dataclasses.replace(cfg, n_layers=3), ref,
                             "cpu")


@pytest.mark.parametrize("md,comp", [("f32", None), ("int8", "int8")],
                         ids=["f32-none", "int8-int8"])
def test_reference_checkpoint_resumes_in_the_port(tmp_path, md, comp):
    """The reference trains 2 steps and saves; the port restores the
    checkpoint (like its own fresh state) and takes step 3, which is the
    reference's step 3."""
    cfg, jinit, jstep, step = _steps(md, comp)
    pipe = _pipe(cfg.vocab)
    js = jinit(jax.random.key(0))
    for k in range(2):
        js, _ = jstep(js, pipe.batch(k))
    jckpt.save(str(tmp_path), 1, js)
    init, _ = make_lm_train_step(cfg, adamw.AdamWConfig(moment_dtype=md),
                                 CompressConfig(kind=comp) if comp else None,
                                 device="cpu")
    ts, saved = ckpt_lib.restore(str(tmp_path),
                                 like=init(torch.Generator().manual_seed(0)))
    assert saved == 1 and int(ts["opt"]["step"]) == 2
    js, jm = jstep(js, pipe.batch(2))
    ts, tm = step(ts, pipe.batch(2))
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-3)
    if md == "f32":  # and back: the port's checkpoint in the reference
        ckpt_lib.save(str(tmp_path), 2, ts)
        back, _ = jckpt.restore(str(tmp_path), like=js)
        for (p, a), b in zip(tree_lib.leaves(state_to_numpy(ts)),
                             jax.tree.leaves(back)):
            np.testing.assert_array_equal(a, np.asarray(b), err_msg=str(p))


# ---------------------------------------------------------------------------
# Restarts (mirrors of tests/test_fault_tolerance.py)
# ---------------------------------------------------------------------------

CFG = T.TransformerConfig(name="t", n_layers=2, d_model=32, n_heads=4,
                          n_kv=2, d_ff=64, vocab=128, head_dim=8)
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)


def _pipeline():
    return P.LMPipeline(P.LMDataConfig(vocab=128, batch=2, seq=16, seed=7))


def _supervised(ckpt_dir, chaos, compress=None):
    pipe = _pipeline()
    init_fn, step_fn = make_lm_train_step(CFG, OPT, compress, device="cpu")

    def do_step(st, step):
        st, _ = step_fn(st, pipe.batch(step))
        return st

    sup = Supervisor(ckpt_dir, save_every=3, keep=5)
    return sup.run(init_state=lambda: init_fn(torch.Generator().manual_seed(1)),
                   step_fn=do_step, n_steps=10, chaos=chaos)


@pytest.mark.parametrize("fail_at", [(4, 8), (1,)], ids=["4-8", "1"])
def test_restart_is_bit_exact(tmp_path, fail_at):
    """Training with injected failures reaches the same state as without;
    a failure at step 1 comes before the first save, so the run restarts
    from a fresh initial state (the stepped one was updated in place)."""
    clean = _supervised(str(tmp_path / "a"), None)
    chaotic = _supervised(str(tmp_path / "b"),
                          ChaosConfig(fail_at_steps=fail_at))
    for (p, a), (_, b) in zip(tree_lib.leaves(clean["params"]),
                              tree_lib.leaves(chaotic["params"])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   err_msg=str(p))


def test_pipeline_determinism():
    p1 = _pipeline()
    p2 = _pipeline()
    b1 = p1.batch(17)
    b2 = p2.batch(17)
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert not np.array_equal(p1.batch(17)["tokens"], p1.batch(18)["tokens"])


# ---------------------------------------------------------------------------
# Data streams
# ---------------------------------------------------------------------------


def _same_batch(got: dict, want: dict):
    assert set(got) == set(want)
    for k in got:
        a, b = np.asarray(got[k]), np.asarray(want[k])
        assert a.dtype == b.dtype and a.shape == b.shape, k
        np.testing.assert_array_equal(a, b, err_msg=k)


def test_pipelines_match_reference_bitwise():
    for step in (0, 5, 17):
        _same_batch(P.LMPipeline(P.LMDataConfig(512, 3, 64, seed=2))
                    .batch(step),
                    JP.LMPipeline(JP.LMDataConfig(512, 3, 64, seed=2))
                    .batch(step))
        _same_batch(P.RecsysPipeline(P.RecsysDataConfig(1000, 5, 8, 3, 4))
                    .batch(step),
                    JP.RecsysPipeline(JP.RecsysDataConfig(1000, 5, 8, 3, 4))
                    .batch(step))
        meta = {"batch": 4, "n": 9, "e": 12, "d": 5}
        _same_batch(P.GraphPipeline(P.GraphDataConfig("molecule", 3, meta))
                    .batch(step),
                    JP.GraphPipeline(JP.GraphDataConfig("molecule", 3, meta))
                    .batch(step))


def test_neighbor_sampler_matches_reference_bitwise():
    """On a graph where every vertex has an out-arc (see the next test for
    one where the last has none)."""
    g, jg = G.ring_of_cliques(16, 8), JG.ring_of_cliques(16, 8)
    spec, jspec = S.SamplerSpec(16, (5, 3)), JS.SamplerSpec(16, (5, 3))
    assert (spec.node_budget, spec.edge_budget) == (jspec.node_budget,
                                                    jspec.edge_budget)
    ours, theirs = S.NeighborSampler(g, spec, 4), JS.NeighborSampler(jg,
                                                                     jspec, 4)
    cfg = P.GraphDataConfig("sampled", 1, {"batch": 16})
    jcfg = JP.GraphDataConfig("sampled", 1, {"batch": 16})
    pipe, jpipe = P.GraphPipeline(cfg, g, ours), JP.GraphPipeline(jcfg, jg,
                                                                  theirs)
    for step in range(3):
        _same_batch(pipe.batch(step), jpipe.batch(step))


def test_neighbor_sampler_shares_the_reference_fault():
    """A frontier vertex of out-degree 0 past every arc (here the last
    vertex of R-MAT scale 8) reads ``indices[nnz]``: the copy raises where
    the reference does (ROADMAP.md, queue 3)."""
    seeds = np.arange(240, 256, dtype=np.int64)
    for gen, mod in ((G, S), (JG, JS)):
        sampler = mod.NeighborSampler(gen.rmat(8, 8, seed=0),
                                      mod.SamplerSpec(16, (5, 3)), 4)
        with pytest.raises(IndexError):
            sampler.sample(seeds)


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------


def test_launch_train_smoke_cpu(capsys):
    losses = launch_train.main(["--arch", "gemma2-27b", "--smoke", "--steps",
                                "8", "--device", "cpu"])
    assert len(losses) == 8 and losses[-1] < losses[0]
    out = capsys.readouterr().out
    assert out.startswith("[train] arch=gemma2-smoke params=0.2M batch=8 "
                          "seq=128\n[train] step 0 loss ")
    assert "[train] done: first loss" in out


def test_launch_train_resumes_to_the_clean_run(tmp_path):
    argv = ["--arch", "command-r-plus-104b", "--smoke", "--steps", "6",
            "--save-every", "3", "--compress", "int8", "--device", "cpu",
            "--batch", "2", "--seq", "32"]
    clean = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "a")])
    chaotic = launch_train.main(argv + ["--ckpt-dir", str(tmp_path / "b"),
                                        "--fail-at", "1", "4"])
    # re-run after the failures: step 0 (no save yet) and step 3 (the
    # save after step 2)
    assert len(chaotic) == len(clean) + 2
    a, _ = ckpt_lib.restore(str(tmp_path / "a"))
    b, _ = ckpt_lib.restore(str(tmp_path / "b"))
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, err_msg=k)
