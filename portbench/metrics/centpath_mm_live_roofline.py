"""centpath_mm_live_roofline (%): the centpath product (``centpath_mm.cu``,
main and fold kernels) against its bound over the k it walks: launches in
the window at the cell's product shape, each at the launches' mean live k
(``common/live_bound.py``), over the device seconds the trace gives the
file's kernels. ``centpath_mm_roofline`` bounds the same time over all n
of k. Nothing where the program counts no live k."""
from portbench.metrics.common import live_bound


def read(ctx):
    return live_bound.single_card_share(ctx, "centpath_mm")
