"""products_live_share (ratio): the share of the dense products'
contraction that the frontier keeps live: the program's
``products.k_live`` over ``products.k`` counters (``repro_torch.kernels.
live_k``, one of each a product launch on the card) in the traced window.
In the four-card cell, rank 0's. Nothing where the program has no such
counters (a product that sweeps every k), or nothing was counted."""
from portbench.metrics.common import live_bound


def read(ctx):
    snap = live_bound.snapshot(ctx)
    if snap is None:
        return None
    k = snap.counters.get("products.k")
    live = snap.counters.get("products.k_live")
    if not k or live is None:
        return None
    return live / k
