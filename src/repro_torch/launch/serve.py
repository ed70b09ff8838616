"""Serving launcher: batched prefill + decode with a KV cache.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma2-27b \
      --smoke --batch 4 --prompt-len 32 --gen 16 [--device cuda|cpu]

A port of ``repro/launch/serve.py``. The weights are drawn by
``init_params`` from a CPU ``torch.Generator`` seeded 0 (so ``--device
cuda`` and ``--device cpu`` serve the same model), the prompts from
numpy's ``default_rng(0)`` as the reference draws them. ``--device``
defaults to the card and exits naming ``--device cpu`` on a host without
one.

``--temperature`` > 0 samples from the softmax with an explicit
``torch.Generator`` (seeded 0, on the model's device).
``jax.random.categorical``'s stream cannot be reproduced, so the port
gives the reference's tokens at temperature 0 (greedy) only.
"""
from __future__ import annotations

import argparse
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_arch
from repro_torch.models import transformer as T


def generate(model: T.Transformer, prompts: torch.Tensor, gen: int, *,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefill ``prompts`` (B, P) into a fresh cache of P + gen positions,
    then decode. The first token is the prefill's argmax; each later one
    the argmax of its step's logits, or at ``temperature`` > 0 a sample
    drawn with ``generator``. Returns the tokens (B, gen) and the logits
    each was taken from (B, gen, vocab)."""
    B, P = prompts.shape
    cache = T.init_cache(model.cfg, B, P + gen, device=model.device)
    logits, cache = T.prefill(model, prompts, cache)
    tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
    out, seen = [tok], [logits[:, -1]]
    for i in range(gen - 1):
        logits, cache = T.decode_step(model, tok, P + i, cache)
        if temperature > 0:
            probs = torch.softmax(logits[:, -1] / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(logits[:, -1], dim=-1)[:, None]
        out.append(tok)
        seen.append(logits[:, -1])
    return torch.cat(out, dim=1), torch.stack(seen, dim=1)


def model_and_prompts(cfg: T.TransformerConfig, batch: int, prompt_len: int,
                      device) -> Tuple[T.Transformer, torch.Tensor]:
    """``main``'s model (weights from a CPU generator seeded 0) and
    prompts (numpy's ``default_rng(0)``, as the reference's) on
    ``device``."""
    model = T.init_params(cfg, torch.Generator().manual_seed(0), device)
    rng = np.random.default_rng(0)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab, (batch, prompt_len)),
                              dtype=torch.long, device=model.device)
    return model, prompts


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma2-27b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        raise SystemExit(f"[serve] {e}")

    spec = get_arch(args.arch)
    if spec.family != "lm":
        raise SystemExit(f"[serve] {args.arch} is a {spec.family} "
                         f"architecture; launch.serve drives LM archs")
    cfg = spec.config(smoke=args.smoke)
    model, prompt = model_and_prompts(cfg, args.batch, args.prompt_len, dev)
    sampler = torch.Generator(device=dev).manual_seed(0)

    t0 = time.time()
    gen, _ = generate(model, prompt, args.gen,
                      temperature=args.temperature, generator=sampler)
    gen = gen.cpu().numpy()
    dt = time.time() - t0
    print(f"[serve] arch={cfg.name} batch={args.batch} "
          f"prompt={args.prompt_len} gen={gen.shape[1]} "
          f"tok/s {args.batch * gen.shape[1] / dt:,.1f}")
    print("[serve] sample token ids:", gen[0, :12])
    if gen.shape != (args.batch, args.gen):
        raise AssertionError(f"generated {gen.shape}, expected "
                             f"{(args.batch, args.gen)}")
    return gen


if __name__ == "__main__":
    main()
