"""Which device operations in a trace belong to which layer, by name.

The hand-written kernels are found by their ``__global__`` functions'
names (templated ones appear as ``void name<...>(...)``); copies and
sets by the profiler's own names for them.
"""
from __future__ import annotations

import re

# The __global__ functions of each file under
# src/repro_torch/kernels/csrc/.
FUNCTIONS = {
    "multpath_mm": ("multpath_mm_kernel", "multpath_fold_kernel"),
    "centpath_mm": ("centpath_mm_kernel", "centpath_fold_kernel"),
    "segment_relax": ("segment_relax_prep", "segment_relax_main"),
}
_OF = {k: re.compile(r"\b(" + "|".join(fns) + r")\b")
       for k, fns in FUNCTIONS.items()}


def of_kernel(kernel: str):
    """Predicate: the operation is one of ``kernel``'s file."""
    pattern = _OF[kernel]
    return lambda name: pattern.search(name) is not None


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset"))


def is_torch_op(name: str) -> bool:
    """A kernel outside the hand-written files and copies: PyTorch's own
    operations."""
    return not (is_copy(name) or any(p.search(name) for p in _OF.values()))
