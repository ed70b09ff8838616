"""torch_ops_ms_per_batch (ms): device time per call in PyTorch's own
kernels, outside the three hand-written files and copies: the
batch bodies' elementwise work, the dense child count, the CSR
expansion, scatters and sorts."""
from portbench.metrics.common import kernels


def read(ctx):
    if ctx.trace is None or not ctx.batches:
        return None
    t = ctx.trace.seconds(kernels.is_torch_op)
    return 1e3 * t / ctx.batches if t > 0 else None
