"""Which device operations of a trace are collectives: NCCL's kernels, by
the names it gives them (``ncclDevKernel_AllGather_RING_LL(...)``, and
``ncclKernel_...`` in older releases)."""
from __future__ import annotations

import re

_NCCL = re.compile(r"\bnccl(Dev)?Kernel_")


def is_nccl(name: str) -> bool:
    return _NCCL.search(name) is not None
