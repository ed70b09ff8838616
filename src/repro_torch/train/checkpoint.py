"""Fault-tolerant checkpointing, in the reference's on-disk format.

A port of ``repro/train/checkpoint.py``:

* ``save(dir, step, tree)`` — writes ``step_XXXXXXXXXX/arrays.npz`` (each
  leaf, keyed by its path joined by ``/``, stored as ``__``) and
  ``manifest.json`` into a ``.tmp`` stage, then **atomically renames**
  it (a crash mid-save never corrupts the latest checkpoint); only the
  newest ``keep`` checkpoints are retained.
* ``restore(dir, like=...)`` — the flat ``{path: array}`` dict, or, with
  ``like``, ``like``'s structure with each leaf on that leaf's device and
  dtype (a tensor on its device, a numpy array or scalar on the host).
* ``latest_step(dir)`` / ``all_steps(dir)`` — the restart loop's entry
  point.

A tree is nested dicts (walked in sorted key order, as
``jax.tree_util`` walks them), lists and tuples whose leaves are tensors,
numpy arrays or scalars; ``None`` is an empty subtree. A bfloat16 leaf
(int8 AdamW's ``v``) is stored as its raw 2-byte words, as ``np.savez``
stores the reference's (``to_numpy`` / ``from_numpy``). Since the paths,
the leaf order and the files are the reference's, a checkpoint written by
either package restores in the other. For BC runs the checkpoint is tiny:
the cumulative λ, the batch index and the batch size.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

_SEP = "/"


def _leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[str, Any]]:
    """(key, leaf) pairs in the order ``jax.tree_util`` flattens them."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, path + (str(i),))
    else:
        yield _SEP.join(path), tree


def _flatten(tree) -> Dict[str, Any]:
    return dict(_leaves(tree))


def to_numpy(leaf) -> np.ndarray:
    """A leaf on the host. numpy has no bfloat16, so a bf16 tensor comes
    back as its raw 2-byte words (dtype ``V2``), the form in which
    ``np.savez`` stores the reference's bf16 arrays."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def from_numpy(arr: np.ndarray, device, dtype: Optional[torch.dtype] = None
               ) -> torch.Tensor:
    """A host array as a tensor on ``device`` (of ``dtype``, default its
    own). Raw 2-byte words (``V2``, or ml_dtypes' bfloat16, whose kind is
    also ``V``) are read as bfloat16, bit for bit."""
    arr = np.asarray(arr)
    if arr.dtype.kind == "V" and arr.dtype.itemsize == 2:
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))
    return t.to(device=device, dtype=dtype or t.dtype)


def save(ckpt_dir: str, step: int, tree, *, keep: int = 3) -> str:
    """Atomic checkpoint write. Returns the final directory path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    stage = final + ".tmp"
    if os.path.exists(stage):
        shutil.rmtree(stage)
    os.makedirs(stage)
    arrays = {}
    meta = {"step": step, "keys": []}
    for k, v in _flatten(tree).items():
        arr = to_numpy(v)
        arrays[k] = arr
        meta["keys"].append({"key": k, "shape": list(arr.shape),
                             "dtype": str(arr.dtype)})
    np.savez(os.path.join(stage, "arrays.npz"),
             **{k.replace(_SEP, "__"): v for k, v in arrays.items()})
    with open(os.path.join(stage, "manifest.json"), "w") as f:
        json.dump(meta, f)
    os.replace(stage, final)  # atomic publish
    _retain(ckpt_dir, keep)
    return final


def _retain(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str):
    out = []
    if not os.path.isdir(ckpt_dir):
        return out
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            out.append(int(name[5:]))
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _like(arr: np.ndarray, ref):
    """``arr`` as ``ref`` holds its leaf: a tensor on ``ref``'s device and
    dtype, a numpy array of its dtype, or a scalar of its type."""
    if isinstance(ref, torch.Tensor):
        return from_numpy(arr, ref.device, ref.dtype)
    if isinstance(ref, np.ndarray):
        return np.asarray(arr, dtype=ref.dtype)
    if isinstance(ref, np.generic):
        return ref.dtype.type(arr)
    return type(ref)(arr.item())


def _rebuild(like, flat: Dict[str, np.ndarray], path: Tuple[str, ...] = ()):
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _rebuild(v, flat, path + (str(k),))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, flat, path + (str(i),))
                          for i, v in enumerate(like))
    return _like(flat[_SEP.join(path)], like)


def restore(ckpt_dir: str, step: Optional[int] = None, *, like=None):
    """Load a checkpoint (the latest by default): ``(flat, step)`` with
    ``flat`` the ``{path: array}`` dict, or, with ``like``, ``(tree,
    step)`` in ``like``'s structure, each leaf placed as ``like``'s."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    with np.load(os.path.join(final, "arrays.npz")) as data:
        flat = {k.replace("__", _SEP): data[k] for k in data.files}
    if like is None:
        return flat, step
    return _rebuild(like, flat), step
