"""segment_relax_ms_per_batch (ms): device time of the sparse relax
(``segment_relax.cu``) per call in the window. Its roofline share waits
for each launch's live arcs, which the program does not count yet."""
from portbench.metrics.common import kernels


def read(ctx):
    if ctx.trace is None or not ctx.batches or not ctx.launches.get(
            "segment_relax"):
        return None
    return 1e3 * ctx.trace.seconds(
        kernels.of_kernel("segment_relax")) / ctx.batches
