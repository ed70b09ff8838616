"""child_count_roofline (%): the dense SP-DAG child count kernel
(``child_count.cu``) against its bound: the least seconds of each dense
count in the window (``common/child_count_bound.py``, at the rows and n of
the program's ``child_count`` spans with ``dense`` 1,
``repro_torch.tracing``), summed, over the device seconds the trace gives
the file's ``__global__`` functions. Nothing unless those spans number
exactly the window's ``child_count.launch`` counts, nor where the trace
has no time in the kernel (the CPU, the COO form)."""
import re

from portbench.metrics.common.child_count_bound import child_count_bound_s

# The __global__ functions of src/repro_torch/kernels/csrc/child_count.cu
# (templated: ``void ...child_count_kernel<true>(...)`` in the trace).
_KERNEL = re.compile(r"\bchild_count_kernel\b")


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    snap = tracing.snapshot(clear=False)
    dense = [s.attrs for s in snap.named("child_count")
             if s.attrs.get("dense") == 1]
    launches = snap.counters.get("child_count.launch", 0)
    if not launches or len(dense) != launches:
        return None
    t = ctx.trace.seconds(lambda name: _KERNEL.search(name) is not None)
    if t <= 0:
        return None
    bound = sum(child_count_bound_s(a["rows"], a["n"]) for a in dense)
    return 100.0 * bound / t
