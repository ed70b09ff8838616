"""centpath_mm_roofline (%): the centpath product (``centpath_mm.cu``,
main and fold kernels) against its bound: launches in the window times
the least seconds one launch at the cell's product shape takes
(``common/bounds.py``), over the device seconds the trace gives the
file's kernels."""
from portbench.metrics.common import bounds, kernels


def read(ctx):
    launches = ctx.launches.get("centpath_mm", 0)
    if not launches or ctx.trace is None or ctx.product_shape is None:
        return None
    t = ctx.trace.seconds(kernels.of_kernel("centpath_mm"))
    if t <= 0:
        return None
    return 100.0 * launches * bounds.product_bound_s(
        "centpath_mm", *ctx.product_shape) / t
