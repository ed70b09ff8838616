"""collective_ms_per_batch (ms): device time of rank 0's collectives per
call: the NCCL kernels (``common/collectives.py``) in its traced window,
over its calls. Nothing where no collective ran on a card (one card, or
gloo on the CPU)."""
from portbench.metrics.common.collectives import is_nccl


def read(ctx):
    if ctx.trace is None or not ctx.batches:
        return None
    t = ctx.trace.seconds(is_nccl)
    return 1e3 * t / ctx.batches if t > 0 else None
