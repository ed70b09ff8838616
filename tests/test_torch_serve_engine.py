"""The port's continuous-batching engine and serving launcher.

* The mirror of ``tests/test_serve_engine.py`` on the port alone: four
  requests through two slots (slots recycle) give the tokens of a
  teacher-forced greedy ``forward``; EOS frees a slot early.
* ``repro_torch.serve.engine.ServeEngine`` against
  ``repro.serve.engine.ServeEngine`` on the same carried weights and
  requests, tick by tick, token for token: the reference test's config, a
  windowed config (gemma2-smoke, window 16) whose prompts pass the
  window, and moonshot-smoke (MoE with a shared expert; idle slots in a
  tick take part in the experts' capacity). A differing token is
  accepted only where the reference's logits of that step put the two
  tokens within 1e-5; the comparison then stops, since the schedules
  diverge. Each case prints how many such positions it met.
* ``repro_torch.launch.serve``'s generation loop against the reference's
  ``main([...])`` at temperature 0 on carried weights: the same token ids;
  the port's CLI on the CPU, greedy and sampled.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_arch as jget_arch
from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro.serve import engine as jengine
from repro_torch.launch import serve
from repro_torch.models import transformer as T
from repro_torch.serve.engine import Request, ServeEngine

from test_torch_lm import carry, near_tie, reference_params

CFG = T.TransformerConfig(name="s", n_layers=2, d_model=32, n_heads=4,
                          n_kv=2, d_ff=64, vocab=64, head_dim=8)
TIE = 1e-5


def _greedy_reference(model, prompt, n_new):
    """Teacher-forced greedy continuation via full forward passes."""
    seq = list(prompt)
    for _ in range(n_new):
        logits = T.forward(model, torch.as_tensor([seq]))
        seq.append(int(torch.argmax(logits[0, -1])))
    return seq[len(prompt):]


def test_engine_matches_reference_and_recycles_slots():
    model = T.init_params(CFG, torch.Generator().manual_seed(0), "cpu")
    eng = ServeEngine(model, n_slots=2, max_len=48)
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, 64, L).astype(np.int32),
                    max_new=m)
            for i, (L, m) in enumerate([(5, 6), (7, 4), (3, 5), (6, 3)])]
    for r in reqs:
        eng.submit(r)  # 4 requests through 2 slots -> slots must recycle
    done = eng.run()
    assert len(done) == 4 and all(r.done for r in done)
    for r in reqs:
        ref = _greedy_reference(model, r.prompt, r.max_new)
        assert r.out == ref, (r.rid, r.out, ref)


def test_engine_eos_frees_slot_early():
    model = T.init_params(CFG, torch.Generator().manual_seed(1), "cpu")
    eng = ServeEngine(model, n_slots=1, max_len=32, eos_id=None)
    r = Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new=3)
    eng.submit(r)
    done = eng.run()
    assert len(done) == 1 and len(r.out) == 3
    # with its second token as EOS, the request retires after two tokens
    # and the one slot serves the next request
    eos = r.out[1]
    eng = ServeEngine(model, n_slots=1, max_len=32, eos_id=eos)
    a = Request(rid=0, prompt=np.arange(4, dtype=np.int32), max_new=6)
    b = Request(rid=1, prompt=np.arange(5, 9, dtype=np.int32), max_new=2)
    eng.submit(a)
    eng.submit(b)
    assert eng.run() == [a, b] and a.done and b.done
    assert a.out == r.out[:r.out.index(eos) + 1]
    assert 1 <= len(b.out) <= 2 and not eng.active


class _Recorded:
    """The reference engine's jitted decode, keeping the logits of each
    token it gives, keyed (rid, index in ``out``), so that a differing
    token can be judged, and the most slots a call decoded with no
    request in them."""

    def __init__(self, eng):
        self.eng, self.fn, self.logits, self.idle = eng, eng._decode, {}, 0

    def __call__(self, params, tok, pos, cache, row_mask):
        self.idle = max(self.idle, sum(s.rid < 0 for s in self.eng.slots))
        logits, cache = self.fn(params, tok, pos, cache, row_mask)
        rows = np.asarray(logits[:, -1])
        for i in np.flatnonzero(np.asarray(row_mask)):
            rid = self.eng.slots[i].rid
            self.logits[rid, len(self.eng.active[rid].out)] = rows[i]
        return logits, cache


ENGINE_CASES = {
    # name: (arch, n_slots, max_len, [(prompt len, max_new)])
    "reference_test": (None, 2, 48, [(5, 6), (7, 4), (3, 5), (6, 3)]),
    "window": ("gemma2-27b", 3, 64, [(20, 8), (30, 6), (20, 10), (30, 5)]),
    "moe_idle_rows": ("moonshot-v1-16b-a3b", 3, 48,
                      [(9, 6), (12, 3), (9, 9), (12, 4), (9, 2)]),
}


def _reference_cfg(arch):
    if arch is not None:
        return jget_arch(arch).config(smoke=True)
    return JT.TransformerConfig(**{
        k: getattr(CFG, k) for k in ("name", "n_layers", "d_model", "n_heads",
                                     "n_kv", "d_ff", "vocab", "head_dim")})


@pytest.mark.parametrize("case", list(ENGINE_CASES))
def test_engine_matches_reference_engine(case):
    arch, n_slots, max_len, shapes = ENGINE_CASES[case]
    jcfg = _reference_cfg(arch)
    params = reference_params(jcfg, 3)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, jcfg.vocab, L).astype(np.int32)
               for L, _ in shapes]
    jeng = jengine.ServeEngine(jcfg, params, n_slots=n_slots,
                               max_len=max_len)
    jeng._decode = rec = _Recorded(jeng)
    teng = ServeEngine(carry(jcfg, params), n_slots=n_slots, max_len=max_len)
    jreqs = [jengine.Request(rid=i, prompt=p, max_new=m)
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    treqs = [Request(rid=i, prompt=p, max_new=m)
             for i, (p, (_, m)) in enumerate(zip(prompts, shapes))]
    for jr, tr in zip(jreqs, treqs):
        jeng.submit(jr)
        teng.submit(tr)
    ticks, tie = 0, None
    while (jeng.queue or jeng.active) and tie is None:
        jeng.step()
        teng.step()
        ticks += 1
        for r, (jr, tr) in enumerate(zip(jreqs, treqs)):
            j = next((j for j, (a, b) in enumerate(zip(jr.out, tr.out))
                      if a != b), None)
            if j is None:
                assert len(jr.out) == len(tr.out), (case, r)
                continue
            if j == 0:  # the prefill's token, from the prompt alone
                logits = np.asarray(JT.prefill(
                    jcfg, params, jnp.asarray(prompts[r][None]),
                    JT.init_cache(jcfg, 1, max_len))[0])[0, -1]
            else:
                logits = rec.logits[r, j]
            assert near_tie(logits, jr.out[j], tr.out[j], TIE), \
                (case, r, j, jr.out[j], tr.out[j])
            tie = (r, j)  # the schedules diverge from here
            break
    n_tok = sum(len(r.out) for r in jreqs)
    print(f"[engine {case}] {ticks} ticks, {n_tok} tokens, at most "
          f"{rec.idle} idle slot(s) in a decode, {int(tie is not None)} "
          f"near-tie position(s)")
    if tie is None:
        assert [r.out for r in treqs] == [r.out for r in jreqs]
        assert [r.rid for r in teng.finished] == \
            [r.rid for r in jeng.finished]
        assert all(r.done for r in treqs) and not teng.active
    if arch == "moonshot-v1-16b-a3b":
        assert rec.idle > 0  # idle rows decoded with the active ones


LAUNCH_ARCHS = ["gemma2-27b", "moonshot-v1-16b-a3b"]


@pytest.mark.parametrize("arch", LAUNCH_ARCHS)
def test_launch_generation_matches_reference_main(arch):
    """The reference's ``main`` draws its weights from ``jax.random.key(0)``
    and its prompts from ``default_rng(0)``; the port's ``generate`` on
    those weights and prompts gives the same token ids at temperature 0."""
    argv = ["--arch", arch, "--smoke", "--batch", "3", "--prompt-len", "20",
            "--gen", "10"]
    want = jserve.main(argv)
    jcfg = jget_arch(arch).config(smoke=True)
    model = carry(jcfg, JT.init_params(jcfg, jax.random.key(0)))
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (3, 20))
    got, logits = serve.generate(model, torch.as_tensor(prompts), 10)
    assert logits.shape == (3, 10, jcfg.vocab)
    np.testing.assert_array_equal(got.numpy(), want)


def test_launch_main_on_the_cpu(capsys):
    argv = ["--arch", "granite-34b", "--smoke", "--batch", "2",
            "--prompt-len", "6", "--gen", "5", "--device", "cpu"]
    greedy = serve.main(argv)
    assert greedy.shape == (2, 5)
    assert "[serve] arch=granite-smoke batch=2 prompt=6 gen=5" in \
        capsys.readouterr().out
    np.testing.assert_array_equal(serve.main(argv), greedy)
    hot = argv + ["--temperature", "5.0"]
    sampled = serve.main(hot)
    np.testing.assert_array_equal(serve.main(hot), sampled)  # seeded
    assert sampled.shape == (2, 5) and (sampled[:, 0] == greedy[:, 0]).all()
    assert ((0 <= sampled) & (sampled < 512)).all()
