#!/usr/bin/env python3
"""How far f32 LM gradients lie from an f64 evaluation, port and reference.

    PYTHONPATH=src python3 tools/torch_grad_noise.py [arch ...]

For each smoke architecture (default: gemma2-27b, moonshot-v1-16b-a3b,
command-r-plus-104b): the reference's weights (``repro.models.
transformer.init_params``, key 0), one batch of 2 × 32 tokens, and the
gradient of the next-token loss by

* the reference (``jax.value_and_grad``, f32),
* the port (``repro_torch.train.train_lib.value_and_grad``, f32),
* the port on the same weights in f64 with its f32 casts (RMSNorm, the
  attention softmax, the logits) kept in f64: the yardstick.

Prints, per leaf, each f32 gradient's largest distance from the f64 one
and the port's from the reference's, each over the leaf's largest f64
magnitude. CPU only; about 20 s an architecture.
"""
import dataclasses
import os
import sys

import jax
import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", "src"))

from repro.configs import get_arch as jget_arch  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch import tree as tree_lib  # noqa: E402
from repro_torch.train.train_lib import (state_from_reference,  # noqa: E402
                                         value_and_grad)


def port_cfg(jcfg) -> T.TransformerConfig:
    kw = {f.name: getattr(jcfg, f.name)
          for f in dataclasses.fields(T.TransformerConfig)
          if f.name not in ("dtype", "moe")}
    moe = None if jcfg.moe is None else L.MoeConfig(
        **dataclasses.asdict(jcfg.moe))
    return T.TransformerConfig(**kw, moe=moe)


def main(archs) -> None:
    for arch in archs:
        jcfg = jget_arch(arch).config(smoke=True)
        cfg = port_cfg(jcfg)
        params = jax.jit(lambda k: JT.init_params(jcfg, k))(jax.random.key(0))
        toks = np.random.default_rng(1).integers(0, cfg.vocab, (2, 33))
        x, y = toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: JT.loss_fn(jcfg, p, x, y)))(params)
        tree = state_from_reference(
            cfg, {"params": jax.tree.map(np.asarray, params)},
            "cpu")["params"]
        X, Y = torch.as_tensor(x).long(), torch.as_tensor(y).long()
        tl, tg = value_and_grad(lambda p: T.loss_fn((cfg, p), X, Y), tree)
        # the yardstick: f64 throughout, the f32 casts made no-ops
        f32 = torch.Tensor.float
        torch.Tensor.float = lambda t: t if t.dtype == torch.float64 \
            else f32(t)
        try:
            c64 = dataclasses.replace(cfg, dtype=torch.float64)
            sl, sg = value_and_grad(
                lambda p: T.loss_fn((c64, p), X, Y),
                tree_lib.tree_map(lambda a: a.double(), tree))
        finally:
            torch.Tensor.float = f32
        print(f"{arch} (smoke): loss reference {float(jl):.9f}, port "
              f"{float(tl):.9f}, f64 {float(sl):.9f}")
        print(f"  {'leaf':32s} {'reference':>10s} {'port':>10s} "
              f"{'port-ref':>10s}  (max |diff| / max |g_f64|)")
        for (p, a), b, (_, t) in zip(tree_lib.leaves(tg), jax.tree.leaves(jg),
                                     tree_lib.leaves(sg)):
            a, b = a.numpy().astype(np.float64), np.asarray(b, np.float64)
            t = t.numpy()
            sc = float(np.abs(t).max())
            print(f"  {'/'.join(p):32s} {np.abs(b - t).max() / sc:10.2e} "
                  f"{np.abs(a - t).max() / sc:10.2e} "
                  f"{np.abs(a - b).max() / sc:10.2e}")


if __name__ == "__main__":
    main(sys.argv[1:] or ["gemma2-27b", "moonshot-v1-16b-a3b",
                          "command-r-plus-104b"])
