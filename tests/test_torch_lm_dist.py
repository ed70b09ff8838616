"""The port's sharded LM train step: the counterpart of
``tests/md_lm_dist_check.py``.

One spawned world of 8 gloo ranks on the CPU runs the (2, 2, 2) (pod,
data, model) ``DeviceMesh`` with ``make_policy``'s FSDP + TP rules: the
parameters (the reference's ``init_params`` draw, carried) are DTensors
placed by ``T.place_params``, the step is ``loss_fn`` under the policy,
its gradient and ``adamw.update`` on the DTensors. Its 5 losses on
``LMPipeline``'s batches, every rank's equal to rank 0's, are held to the
same step without a mesh (``NO_SHARDING``) run here, and both to the
reference's unsharded step (``jax.value_and_grad`` of its ``loss_fn`` and
its ``adamw.update``) on the same weights and batches, by the LM
tolerances of ``tests/test_torch_lm.py``: rtol 1e-5 and 1e-4 of the
value's magnitude.

The same world serves one sequence (batch 1, so the KV cache shards its
sequence over (data, model), the reference's ``kv_seq``): a prefill of 8
tokens and 4 greedy decode steps, whose logits are held to the unsharded
calls' and to the reference's ``prefill`` / ``decode_step`` by the same
tolerances.

The module imports neither jax nor ``repro`` at the top: the spawned
ranks import it.
"""
import datetime
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import tree as tree_lib
from repro_torch.data.pipeline import LMDataConfig, LMPipeline
from repro_torch.launch.mesh import make_device_mesh
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch.sharding.rules import NO_SHARDING, make_policy, scope
from repro_torch.train.train_lib import value_and_grad

from _torch_world import run_world

WORLD, STEPS = 8, 5
CFG = T.TransformerConfig(name="d", n_layers=2, d_model=64, n_heads=4,
                          n_kv=2, d_ff=128, vocab=256, head_dim=16)
OPT = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=20)
SCALE_TOL = 1e-4  # tests/test_torch_lm.py's share of the value's magnitude


def _reference_cfg():
    from repro.models import transformer as JT

    return JT.TransformerConfig(**{f: getattr(CFG, f) for f in (
        "name", "n_layers", "d_model", "n_heads", "n_kv", "d_ff", "vocab",
        "head_dim")})


def reference_params():
    """The reference's ``init_params(CFG, key(0))`` as numpy arrays."""
    import jax

    from repro.models import transformer as JT

    return jax.tree.map(np.asarray,
                        JT.init_params(_reference_cfg(), jax.random.key(0)))


def reference_run(params_np) -> list:
    """``run``'s 5 steps in the reference, unsharded; the losses."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT
    from repro.optim import adamw as JA

    jcfg = _reference_cfg()
    jopt = JA.AdamWConfig(lr=OPT.lr, warmup_steps=OPT.warmup_steps,
                          total_steps=OPT.total_steps)

    @jax.jit
    def step(params, opt, tokens, targets):
        loss, grads = jax.value_and_grad(
            lambda p: JT.loss_fn(jcfg, p, tokens, targets))(params)
        params, opt, _ = JA.update(jopt, grads, opt, params)
        return params, opt, loss

    params = jax.tree.map(jnp.asarray, params_np)
    opt = JA.init_state(params)
    pipe = LMPipeline(LMDataConfig(vocab=256, batch=4, seq=32, seed=3))
    losses = []
    for s in range(STEPS):
        b = pipe.batch(s)
        params, opt, loss = step(params, opt, jnp.asarray(b["tokens"]),
                                 jnp.asarray(b["targets"]))
        losses.append(float(loss))
    return losses


def run(policy, params_np) -> list:
    """5 train steps from the carried weights; the losses."""
    tree = tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a)),
                             params_np)
    params = T.place_params(CFG, tree, policy)
    state = adamw.init_state(params)
    pipe = LMPipeline(LMDataConfig(vocab=256, batch=4, seq=32, seed=3))
    losses = []
    for s in range(STEPS):
        b = pipe.batch(s)
        x = torch.from_numpy(np.asarray(b["tokens"])).long()
        y = torch.from_numpy(np.asarray(b["targets"])).long()
        with scope(policy):
            loss, grads = value_and_grad(
                lambda p: T.loss_fn((CFG, p), x, y, policy), params)
            params, state, _ = adamw.update(OPT, grads, state, params)
        losses.append(float(loss.full_tensor() if hasattr(loss, "full_tensor")
                            else loss))
    return losses


PROMPT, DECODE, MAX_LEN = 8, 4, 16


def _prompt() -> np.ndarray:
    return np.asarray(LMPipeline(LMDataConfig(
        vocab=256, batch=1, seq=PROMPT, seed=5)).batch(0)["tokens"])


def reference_serve(params_np) -> list:
    """``serve`` in the reference, unsharded; each call's logits."""
    import jax
    import jax.numpy as jnp

    from repro.models import transformer as JT

    jcfg = _reference_cfg()
    params = jax.tree.map(jnp.asarray, params_np)
    cache = JT.init_cache(jcfg, 1, MAX_LEN)
    logits, cache = JT.prefill(jcfg, params, jnp.asarray(_prompt()), cache)
    out = [np.asarray(logits)]
    for i in range(DECODE):
        nxt = jnp.asarray(out[-1][:, -1].argmax(-1)[:, None])
        logits, cache = JT.decode_step(jcfg, params, nxt,
                                       jnp.int32(PROMPT + i), cache)
        out.append(np.asarray(logits))
    return out


def serve(policy, params_np) -> list:
    """Prefill, then greedy decode of one sequence; each call's logits."""
    tree = tree_lib.tree_map(lambda a: torch.from_numpy(np.array(a)),
                             params_np)
    model = (CFG, T.place_params(CFG, tree, policy))
    cache = T.init_cache(CFG, 1, MAX_LEN, device="cpu", policy=policy)
    toks = torch.from_numpy(_prompt()).long()

    def full(t):
        return (t.full_tensor() if hasattr(t, "full_tensor") else t).numpy()

    with torch.no_grad():
        logits, cache = T.prefill(model, toks, cache, policy)
        out = [full(logits)]
        for i in range(DECODE):
            nxt = torch.from_numpy(out[-1][:, -1].argmax(-1)[:, None])
            logits, cache = T.decode_step(model, nxt, PROMPT + i, cache,
                                          policy)
            out.append(full(logits))
    return out


def _world_main(rank: int, store: str, results, params_np) -> None:
    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=f"file://{store}",
                                rank=rank, world_size=WORLD,
                                timeout=datetime.timedelta(seconds=120))
        mesh = make_device_mesh((2, 2, 2), ("pod", "data", "model"),
                                device_type="cpu")
        pol = make_policy(mesh)
        out = {"train": run(pol, params_np), "serve": serve(pol, params_np)}
        dist.destroy_process_group()
        results.put((rank, out))
    except BaseException:
        results.put((rank, traceback.format_exc()))
        raise


def test_sharded_lm_on_8_ranks_matches_unsharded():
    params_np = reference_params()
    got = run_world(_world_main, WORLD, args=(params_np,))
    plain = run(NO_SHARDING, params_np)
    ref = reference_run(params_np)
    assert ref[-1] < ref[0]
    for rank in range(WORLD):
        assert got[rank]["train"] == got[0]["train"], rank
    for what, losses, want in (("sharded vs unsharded", got[0]["train"],
                                plain),
                               ("sharded vs reference", got[0]["train"], ref),
                               ("unsharded vs reference", plain, ref)):
        np.testing.assert_allclose(losses, want, rtol=1e-5, err_msg=what,
                                   atol=SCALE_TOL * max(abs(v) for v in want))
    # serving over the sequence-sharded cache
    plain = serve(NO_SHARDING, params_np)
    ref = reference_serve(params_np)
    assert len(got[0]["serve"]) == len(plain) == len(ref) == DECODE + 1
    for rank in range(WORLD):
        for a, b in zip(got[rank]["serve"], plain):
            np.testing.assert_allclose(a, b, rtol=1e-5,
                                       atol=SCALE_TOL * np.abs(b).max())
    for a, b in zip(got[0]["serve"] + plain, ref + ref):
        np.testing.assert_allclose(a, b, rtol=1e-5,
                                   atol=SCALE_TOL * np.abs(b).max())
