"""live_k_ms_per_batch (ms): device time of the dense products' live-k
packing (``live_k.cu``: ``live_k_scan`` and ``live_k_gather``, one pair
before each product launch) per call in the window; on the mesh, rank
0's. ``torch_ops_ms_per_batch`` counts the same time among PyTorch's
kernels. Nothing where the trace has none (a program without the
packing, the CPU)."""
import re

# The __global__ functions of src/repro_torch/kernels/csrc/live_k.cu.
_KERNEL = re.compile(r"\blive_k_(scan|gather)\b")


def read(ctx):
    if ctx.trace is None or not ctx.batches:
        return None
    t = ctx.trace.seconds(lambda name: _KERNEL.search(name) is not None)
    if t <= 0:
        return None
    return 1e3 * t / ctx.batches
