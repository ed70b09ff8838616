"""Train step builders wiring model + optimizer + compression.

A port of ``repro/train/train_lib.py``. ``make_lm_train_step`` returns
the training step: loss and gradient, optional gradient compression with
error feedback (the compressed payload is what would cross the DP axis),
AdamW update. The state is the reference's plain dict tree — params
(layers stacked on dim 0), ``opt`` (``m``, ``v``, ``step``) and, when
compressing, ``err`` — of tensors, so it checkpoints in the reference's
format and a checkpoint written by either package resumes in the other.

The reference jits its step and donates nothing on one device; the port
runs it eagerly and updates the state's tensors in place (``adamw.
update``), so a step holds one copy of the state. The gradient is
autograd's, taken on aliases of the state's tensors: the state's own
tensors never require grad, so a state restored from a checkpoint trains
as the one it was saved from.

``state_from_reference`` / ``state_to_numpy`` carry a whole train state
from and to the reference's tree of numpy arrays, bit for bit (bf16 as
``checkpoint.to_numpy`` gives it).
"""
from __future__ import annotations

import gc
import sys
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T
from repro_torch.optim import adamw
from repro_torch import tree as tree_lib
from repro_torch.optim.grad_compress import (CompressConfig, compress,
                                             init_error)
from repro_torch.train.checkpoint import from_numpy, to_numpy


def value_and_grad(loss_fn: Callable, params, *args
                   ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """``loss_fn(params, *args)`` and its gradient, a tree of ``params``'
    structure. ``params``' own tensors are left without grad."""
    fresh = "torch._dynamo" not in sys.modules
    pairs = tree_lib.leaves(params)
    xs = [x.detach().requires_grad_() for _, x in pairs]
    loss = loss_fn(tree_lib.unflatten(zip((p for p, _ in pairs), xs)),
                   *args)
    grads = torch.autograd.grad(loss, xs)
    out = loss.detach(), tree_lib.unflatten(zip((p for p, _ in pairs),
                                                grads))
    del xs, loss, grads
    if fresh and "torch._dynamo" in sys.modules:
        # the process's first ``torch.utils.checkpoint`` call imports
        # torch._dynamo, and the import leaves a reference cycle through
        # the frames on the stack, which hold the parameters, the graph and
        # the gradients: one collection frees them
        gc.collect()
    return out


def _tokens(a, device) -> torch.Tensor:
    """A batch's int32 token array as the int64 tensor ``gather`` and the
    embedding take."""
    return torch.tensor(np.asarray(a), dtype=torch.long, device=device)


def make_lm_train_step(cfg: T.TransformerConfig, opt_cfg: adamw.AdamWConfig,
                       compress_cfg: Optional[CompressConfig] = None, *,
                       device="cuda", chunks: int = 1):
    """Returns (init_fn(generator) -> state, step_fn(state, batch) ->
    (state, metrics)). ``batch`` holds ``tokens`` and ``targets`` (B, S)
    int arrays; the metrics are ``loss``, ``lr`` and ``grad_norm`` (and
    ``wire_bytes`` when compressing), tensors on the device but the
    bytes. ``step_fn`` updates ``state`` in place and returns it."""
    dev = resolve_device(device)
    compressing = compress_cfg is not None and compress_cfg.kind != "none"

    def init_fn(generator: torch.Generator) -> dict:
        params = T.init_tree(cfg, generator, dev)
        state = {"params": params,
                 "opt": adamw.init_state(params, opt_cfg.moment_dtype)}
        if compressing:
            state["err"] = init_error(params)
        return state

    def loss(params, tokens, targets):
        return T.loss_fn((cfg, params), tokens, targets, chunks=chunks)

    def step_fn(state: dict, batch) -> Tuple[dict, dict]:
        lv, grads = value_and_grad(loss, state["params"],
                                   _tokens(batch["tokens"], dev),
                                   _tokens(batch["targets"], dev))
        metrics = {"loss": lv}
        if "err" in state:
            grads, state["err"], wire = compress(compress_cfg, grads,
                                                 state["err"])
            metrics["wire_bytes"] = wire
        _, _, opt_metrics = adamw.update(opt_cfg, grads, state["opt"],
                                         state["params"])
        return state, {**metrics, **opt_metrics}

    return init_fn, step_fn


def make_generic_train_step(loss_fn: Callable, init_params_fn: Callable,
                            opt_cfg: adamw.AdamWConfig):
    """Family-agnostic variant: ``loss_fn(params, batch)`` on a tree of
    tensors drawn by ``init_params_fn(generator)``, f32 moments."""

    def init_fn(generator: torch.Generator) -> dict:
        params = init_params_fn(generator)
        return {"params": params, "opt": adamw.init_state(params)}

    def step_fn(state: dict, batch) -> Tuple[dict, dict]:
        lv, grads = value_and_grad(loss_fn, state["params"], batch)
        _, _, m = adamw.update(opt_cfg, grads, state["opt"],
                               state["params"])
        return state, {"loss": lv, **m}

    return init_fn, step_fn


def state_from_reference(cfg: T.TransformerConfig, ref_state,
                         device="cuda") -> dict:
    """The reference's train state (a tree of numpy arrays: params with
    layers stacked, ``opt.m`` — int8 ``{"q", "s"}`` leaves included —
    ``opt.v``, ``opt.step`` and ``err``) as the port's, bit for bit, on
    ``device``; the params are checked against ``cfg``'s shapes."""
    dev = resolve_device(device)
    want = tree_lib.leaves(T.param_shapes(cfg))
    got = tree_lib.leaves(ref_state["params"])
    shapes = [(p, tuple(np.shape(a))) for p, a in got]
    if shapes != want:
        raise ValueError(f"params of shapes {shapes}, expected {want}")
    return tree_lib.tree_map(lambda a: from_numpy(a, dev), ref_state)


def state_to_numpy(state) -> dict:
    """The port's train state as the reference's tree of numpy arrays
    (bf16 leaves as raw 2-byte words, ``V2``); the inverse of
    ``state_from_reference``."""
    return tree_lib.tree_map(to_numpy, state)
