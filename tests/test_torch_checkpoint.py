"""The port's fault-tolerance half of ``train`` against the reference's.

* ``repro_torch.train.checkpoint``: a nested tree of tensors, arrays and
  scalars round-trips, ``restore(like=)`` placing each leaf on its ``like``
  leaf's dtype and device; writes are atomic and retention keeps the
  newest ``keep`` (mirroring ``tests/test_fault_tolerance.py``); a
  checkpoint written by ``repro.train.checkpoint`` restores in the port
  with equal arrays (dtype, shape, bytes) and an equal manifest, and the
  reverse.
* ``repro_torch.train.fault``: the ``Supervisor`` over an exact BC sweep
  (λ += ``executor.step_sum`` per batch) with injected failures is
  bitwise the unfailed run, and its log is the reference ``Supervisor``'s
  under the same chaos; ``BackupTaskPolicy`` flags the reference's
  stragglers on a seeded latency trace.
* ``repro_torch.train.elastic.bc_elastic_nb`` equals the reference's.
* ``bc_run --ckpt-dir``: a mirror of ``tests/test_bc_api.py``'s resume
  test on the port's CLI, and a checkpoint of the reference's ``bc_run``
  resumed by the port's to the verified λ.
"""
import json
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import bc_run as jbc_run
from repro.train import checkpoint as jckpt
from repro.train import elastic as jelastic
from repro.train import fault as jfault
import repro_torch.bc as tbc
from repro_torch.core.brandes_ref import brandes_bc
from repro_torch.graphs.generators import rmat
from repro_torch.launch import bc_run
from repro_torch.train import checkpoint as ckpt
from repro_torch.train.elastic import bc_elastic_nb, reshard_checkpoint
from repro_torch.train.fault import (BackupTaskPolicy, ChaosConfig,
                                     Supervisor, WorkerFailure)


def _tree():
    rng = np.random.default_rng(0)
    return {"lam": torch.from_numpy(rng.random(7)),  # float64
            "opt": {"mu": [torch.arange(6, dtype=torch.float32).reshape(2, 3),
                           rng.integers(0, 9, (4,)).astype(np.int32)],
                    "flags": (torch.tensor([True, False]), np.float32(2.5))},
            "batch": 3, "nb": 8, "scale": 0.5, "none": None}


def _manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        return json.load(f)


def test_round_trip_places_leaves_like(tmp_path):
    tree = _tree()
    ckpt.save(str(tmp_path), 5, tree)
    flat, step = ckpt.restore(str(tmp_path))
    assert step == 5
    assert sorted(flat) == ["batch", "lam", "nb", "opt/flags/0",
                            "opt/flags/1", "opt/mu/0", "opt/mu/1", "scale"]
    like = {"lam": torch.zeros(7, dtype=torch.float32),
            "opt": {"mu": [torch.zeros(2, 3, dtype=torch.float64),
                           np.zeros(4, np.int64)],
                    "flags": (torch.zeros(2, dtype=torch.bool),
                              np.float64(0))},
            "batch": 0, "nb": 0, "scale": 0.0, "none": None}
    got, step = ckpt.restore(str(tmp_path), like=like)
    assert step == 5 and got["none"] is None
    assert got["lam"].dtype == torch.float32 and got["lam"].device == \
        like["lam"].device
    torch.testing.assert_close(got["lam"], tree["lam"].float(), rtol=0,
                               atol=0)
    mu = got["opt"]["mu"]
    assert mu[0].dtype == torch.float64 and mu[1].dtype == np.int64
    np.testing.assert_array_equal(mu[0].numpy(), tree["opt"]["mu"][0].numpy())
    np.testing.assert_array_equal(mu[1], tree["opt"]["mu"][1])
    flags = got["opt"]["flags"]
    assert isinstance(flags, tuple) and flags[0].dtype == torch.bool
    assert flags[0].tolist() == [True, False]
    assert isinstance(flags[1], np.float64) and flags[1] == 2.5
    assert (got["batch"], got["nb"], got["scale"]) == (3, 8, 0.5)
    assert type(got["batch"]) is int and type(got["scale"]) is float
    # elastic restore is restore(like=) of the latest step
    again, step = reshard_checkpoint(str(tmp_path), like)
    assert step == 5 and torch.equal(again["lam"], got["lam"])


def test_checkpoint_atomic_and_retention(tmp_path):
    for s in range(6):
        ckpt.save(str(tmp_path), s, _tree(), keep=3)
    assert sorted(ckpt.all_steps(str(tmp_path))) == [3, 4, 5]
    assert ckpt.latest_step(str(tmp_path)) == 5
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    # a stage left by a crash mid-save is neither a step nor in the way
    os.makedirs(tmp_path / "step_0000000006.tmp")
    assert ckpt.latest_step(str(tmp_path)) == 5
    ckpt.save(str(tmp_path), 6, _tree(), keep=3)
    assert sorted(ckpt.all_steps(str(tmp_path))) == [4, 5, 6]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"))


def _same_checkpoint(a: str, b: str) -> None:
    """Equal manifests, and equal arrays: names, dtypes, shapes, bytes."""
    assert _manifest(a) == _manifest(b)
    with np.load(os.path.join(a, "arrays.npz")) as x, \
            np.load(os.path.join(b, "arrays.npz")) as y:
        assert x.files == y.files
        for k in x.files:
            assert (x[k].dtype, x[k].shape) == (y[k].dtype, y[k].shape), k
            assert x[k].tobytes() == y[k].tobytes(), k


def test_checkpoints_are_interchangeable_with_the_reference(tmp_path):
    tree = _tree()
    jtree = {"lam": tree["lam"].numpy(),
             "opt": {"mu": [jnp.asarray(tree["opt"]["mu"][0].numpy()),
                            tree["opt"]["mu"][1]],
                     "flags": (jnp.asarray([True, False]),
                               tree["opt"]["flags"][1])},
             "batch": 3, "nb": 8, "scale": 0.5, "none": None}
    ours = ckpt.save(str(tmp_path / "port"), 2, tree)
    theirs = jckpt.save(str(tmp_path / "ref"), 2, jtree)
    _same_checkpoint(ours, theirs)
    # the reference's checkpoint in the port, the port's in the reference
    got, step = ckpt.restore(str(tmp_path / "ref"), like=tree)
    assert step == 2
    for (k, x), (_, y) in zip(ckpt._flatten(got).items(),
                              ckpt._flatten(tree).items()):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), k
    flat, step = jckpt.restore(str(tmp_path / "port"))
    assert step == 2
    want, _ = ckpt.restore(str(tmp_path / "port"))
    assert sorted(flat) == sorted(want)
    for k in flat:
        assert flat[k].dtype == want[k].dtype
        assert flat[k].tobytes() == want[k].tobytes(), k


# -- the Supervisor over a BC sweep -----------------------------------------
N_B = 8
CHAOS = (2, 5)


def _sweep():
    g = rmat(6, 8, seed=5).remove_isolated()[0]
    q = tbc.BCQuery(mode="exact", n_b=N_B,
                    execution=tbc.ExecutionConfig(backend="dense"))
    ex = tbc.build_executor(g, tbc.plan(g, q, n_devices=1, device="cpu"),
                            device="cpu")

    def step_fn(state, b):
        src = np.arange(b * N_B, min((b + 1) * N_B, g.n), dtype=np.int32)
        s1 = ex.step_sum(src, np.ones(src.shape[0], bool))
        return {"lam": state["lam"] + torch.from_numpy(s1), "batch": b}

    init = {"lam": torch.zeros(g.n, dtype=torch.float64), "batch": -1}
    return g, step_fn, init, -(-g.n // N_B)


def test_supervisor_bc_sweep_is_bitwise_the_unfailed_run(tmp_path):
    g, step_fn, init, n_steps = _sweep()
    sup = dict(save_every=2, keep=5)
    clean = Supervisor(str(tmp_path / "clean"), **sup).run(
        init_state=init, step_fn=step_fn, n_steps=n_steps)
    log = []
    chaos = ChaosConfig(fail_at_steps=CHAOS)
    failed = Supervisor(str(tmp_path / "chaos"), **sup).run(
        init_state=init, step_fn=step_fn, n_steps=n_steps, chaos=chaos,
        log=log)
    assert torch.equal(failed["lam"], clean["lam"])
    assert failed["batch"] == clean["batch"] == n_steps - 1
    np.testing.assert_allclose(failed["lam"].numpy(), brandes_bc(g),
                               rtol=1e-5, atol=1e-8)
    # the reference's Supervisor, the same chaos, on a numpy step
    want = []
    jfault.Supervisor(str(tmp_path / "ref"), **sup).run(
        init_state={"x": np.zeros(3)},
        step_fn=lambda st, b: {"x": st["x"] + b}, n_steps=n_steps,
        chaos=jfault.ChaosConfig(fail_at_steps=CHAOS), log=want)
    assert log == want and len(log) == 2 * len(CHAOS)
    # a second run of a finished sweep resumes past its end
    again = []
    Supervisor(str(tmp_path / "chaos"), **sup).run(
        init_state=init, step_fn=step_fn, n_steps=n_steps, log=again)
    assert again == [f"resumed@{n_steps}"]


def test_supervisor_gives_up_after_max_restarts(tmp_path):
    _, step_fn, init, _ = _sweep()
    chaos = ChaosConfig(fail_at_steps=(0, 1, 2))
    with pytest.raises(WorkerFailure, match="step 2"):
        Supervisor(str(tmp_path), save_every=1, max_restarts=2).run(
            init_state=init, step_fn=step_fn, n_steps=4, chaos=chaos)


def test_backup_policy_flags_the_reference_stragglers():
    rng = np.random.default_rng(3)
    ours = BackupTaskPolicy(n_producers=6, threshold=1.8)
    ref = jfault.BackupTaskPolicy(n_producers=6, threshold=1.8)
    flagged = []
    for _ in range(200):
        p = int(rng.integers(0, 6))
        dt = float(rng.exponential(1.0) * (4.0 if p == 2 else 1.0))
        ours.observe(p, dt)
        ref.observe(p, dt)
        assert ours.stragglers() == ref.stragglers()
        flagged.append(tuple(ours.stragglers()))
    assert any(2 in f for f in flagged)
    # fetch: a flagged producer runs twice and the faster result wins
    ticks = iter(np.arange(0.0, 100.0, 0.5))
    out = ours.fetch({p: (lambda p=p: p * 10) for p in range(6)},
                     timer=lambda: next(ticks))
    assert out == {p: p * 10 for p in range(6)}


@pytest.mark.parametrize("p", [1, 4, 64, 1024])
def test_bc_elastic_nb_matches_reference(p):
    for n, m in ((1 << 10, 16 << 10), (1 << 14, 16 << 14), (1000, 3000)):
        for mem in (1e6, 1e9, 8e10):
            assert bc_elastic_nb(n, m, p, mem) == \
                jelastic.bc_elastic_nb(n, m, p, mem)


# -- bc_run --ckpt-dir --------------------------------------------------------
ARGS = ["--graph", "rmat", "--scale", "5", "--nb", "8"]


def _drop_after(ck: str, last: int) -> None:
    for s in ckpt.all_steps(ck):
        if s > last:
            shutil.rmtree(os.path.join(ck, f"step_{s:010d}"))


def test_bc_run_checkpoint_resume(tmp_path, capsys):
    """``tests/test_bc_api.py::test_bc_run_checkpoint_resume`` on the
    port's CLI: cumulative λ checkpoints and the persisted nb survive a
    kill."""
    ck = str(tmp_path / "ck")
    args = ARGS + ["--device", "cpu", "--ckpt-dir", ck, "--verify"]
    full = bc_run.main(args)  # saves cumulative λ at global steps
    flat, step = ckpt.restore(ck)
    np.testing.assert_array_equal(flat["lam"], full)
    assert (int(flat["nb"]), int(flat["batch"])) == (8, step)
    _drop_after(ck, 1)  # a kill after global batch 1
    resumed = bc_run.main(args)  # resumes at batch 2; --verify checks λ
    assert "resuming at batch 2 (nb=8)" in capsys.readouterr().out
    np.testing.assert_allclose(resumed, full, rtol=1e-12, atol=0)
    with pytest.raises(SystemExit, match="mismatches checkpoint"):
        bc_run.main(["--graph", "rmat", "--scale", "5", "--nb", "4",
                     "--device", "cpu", "--ckpt-dir", ck])


def test_bc_run_resumes_a_reference_checkpoint(tmp_path, capsys):
    ck = str(tmp_path / "ck")
    jbc_run.main(ARGS + ["--ckpt-dir", ck])
    _drop_after(ck, 1)
    lam = bc_run.main(ARGS + ["--device", "cpu", "--ckpt-dir", ck,
                              "--verify"])
    out = capsys.readouterr().out
    assert "resuming at batch 2 (nb=8)" in out
    assert "verified against the Brandes oracle" in out
    g = rmat(5, 8, seed=0).remove_isolated()[0]
    np.testing.assert_allclose(lam, brandes_bc(g), rtol=1e-5, atol=1e-8)
