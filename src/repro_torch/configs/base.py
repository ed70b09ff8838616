"""Config system: architectures × input-shape cells (the LM half).

A port of the LM half of ``repro/configs/base.py``. Each architecture
provides an ``ArchSpec`` with:

* ``config(smoke=False)`` — the exact published configuration (or a tiny
  reduced config of the same family for CPU smoke tests);
* ``cells()``             — its input-shape cells (the 4 assigned shapes);
* ``build(cell, smoke)``  — a ``StepBundle``: the step function, the
  layer loop's trip count, the analytic MODEL_FLOPS, and a maker of
  concrete arguments with a check of the outputs.

The reference's bundles also carry abstract, sharded arguments for its
dry-run, which has no counterpart without XLA (slice 7d). Training cells
are slice 7b; the GNN, recsys and BC families are slices 7c and 7d.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.models import transformer as T


@dataclasses.dataclass(frozen=True)
class Cell:
    shape_id: str
    kind: str  # train | prefill | decode | serve | retrieval
    batch: int
    seq: int = 0
    meta: Dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class StepBundle:
    fn: Callable
    trip_counts: Dict[str, int]
    model_flops: float
    # (generator, device="cuda") -> args, drawn from the generator's stream
    concrete_args: Optional[Callable] = None
    check: Optional[Callable] = None  # outputs -> None (smoke assertions)


class ArchSpec:
    arch_id: str = ""
    family: str = ""

    def config(self, smoke: bool = False):
        raise NotImplementedError

    def cells(self) -> Dict[str, Cell]:
        raise NotImplementedError

    def build(self, cell: Cell, smoke: bool = False) -> StepBundle:
        raise NotImplementedError


# ---------------------------------------------------------------------------
# LM family.
# ---------------------------------------------------------------------------

LM_CELLS = {
    "train_4k": Cell("train_4k", "train", batch=256, seq=4096),
    "prefill_32k": Cell("prefill_32k", "prefill", batch=32, seq=32768),
    "decode_32k": Cell("decode_32k", "decode", batch=128, seq=32768),
    "long_500k": Cell("long_500k", "decode", batch=1, seq=524288),
}

LM_SMOKE_CELLS = {
    "train_4k": Cell("train_4k", "train", batch=2, seq=64),
    "prefill_32k": Cell("prefill_32k", "prefill", batch=2, seq=64),
    "decode_32k": Cell("decode_32k", "decode", batch=2, seq=64),
    "long_500k": Cell("long_500k", "decode", batch=1, seq=128),
}


def _check_logits(out) -> None:
    logits, _ = out
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")


class LMArch(ArchSpec):
    family = "lm"

    def __init__(self, arch_id: str,
                 full_cfg: Callable[[], T.TransformerConfig],
                 smoke_cfg: Callable[[], T.TransformerConfig]):
        self.arch_id = arch_id
        self._full = full_cfg
        self._smoke = smoke_cfg

    def config(self, smoke: bool = False) -> T.TransformerConfig:
        return self._smoke() if smoke else self._full()

    def cells(self) -> Dict[str, Cell]:
        return LM_CELLS

    def build(self, cell: Cell, smoke: bool = False,
              layers_override: int = 0) -> StepBundle:
        cfg = self.config(smoke)
        if layers_override:
            cfg = dataclasses.replace(cfg, n_layers=layers_override)
        c = (LM_SMOKE_CELLS if smoke else LM_CELLS)[cell.shape_id]
        B, S = c.batch, c.seq
        n_active = cfg.n_active_params()
        trips = {"while": cfg.n_layers}

        def tokens(generator, shape, device):
            return torch.randint(0, cfg.vocab, shape, generator=generator,
                                 device=generator.device).to(device)

        if c.kind == "train":
            raise NotImplementedError(
                f"{self.arch_id} {cell.shape_id}: training cells are not "
                "ported yet (slice 7b of ROADMAP.md)")

        if c.kind == "prefill":
            def step(model, toks, cache):
                return T.prefill(model, toks, cache)

            def concrete(generator, device="cuda"):
                model = T.init_params(cfg, generator, device)
                return (model, tokens(generator, (B, S), model.device),
                        T.init_cache(cfg, B, S, device=model.device))

            return StepBundle(step, trips, 2.0 * n_active * B * S,
                              concrete_args=concrete, check=_check_logits)

        # decode
        def step(model, token, pos, cache):
            return T.decode_step(model, token, pos, cache)

        def concrete(generator, device="cuda"):
            model = T.init_params(cfg, generator, device)
            return (model, tokens(generator, (B, 1), model.device), S // 2,
                    T.init_cache(cfg, B, S, device=model.device))

        # decode attention also reads O(B·S·kv·hd) cache bytes; FLOPs are
        # 2·N_active per token + attention dot 4·B·S·K·hd·g
        attn_flops = 4.0 * B * S * cfg.n_kv * cfg.hd * (cfg.n_heads // cfg.n_kv)
        return StepBundle(step, trips,
                          2.0 * n_active * B + cfg.n_layers * attn_flops,
                          concrete_args=concrete, check=_check_logits)
