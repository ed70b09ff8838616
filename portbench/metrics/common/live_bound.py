"""The dense products' bound over the k they walk: since the products
skip the frontier's dead columns, a launch contracts over its live k
alone, which the program counts under ``torch.profiler`` in
``products.k_live.<kernel>`` (``repro_torch.kernels.live_k``, beside
``products.k``, every launch's full n).

The counters hold sums, not each launch's live k, so a kind's L launches
are bounded as L launches at their mean live k: L times
``bounds.product_bound_s`` there. Both of its terms are affine in k, so
that is the larger of the launches' summed instruction and summed byte
bounds, which is at most the sum of each launch's own bound: the share
never reads above what each launch's live k would give.
"""
from __future__ import annotations

from portbench.metrics.common import bounds, kernels


def snapshot(ctx):
    """The spans and counters of the traced window: rank 0's shipped
    snapshot on the mesh, else the process's recorder; None untraced or
    where the program has no recorder."""
    if ctx.trace is None:
        return None
    snap = getattr(ctx, "snapshot", None)
    if snap is not None:
        return snap
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    return tracing.snapshot(clear=False)


def live_k(snap, kernel: str):
    """Σ live k of ``kernel``'s launches in the window, or None."""
    return snap.counters.get(f"products.k_live.{kernel}")


def single_card_share(ctx, kernel: str):
    """% of the bound over the live k that ``kernel``'s launches at the
    cell's product shape reach in the device time of the file's kernels.
    Nothing unless ``products.k`` is every product launch's n (each
    launch counted), nor where the program counts no live k."""
    launches = ctx.launches.get(kernel, 0)
    snap = snapshot(ctx)
    if not launches or snap is None or ctx.product_shape is None:
        return None
    nb, n, n2 = ctx.product_shape
    every = sum(ctx.launches.get(k, 0) for k in bounds.N_OUT)
    live = live_k(snap, kernel)
    if live is None or snap.counters.get("products.k") != every * n:
        return None
    t = ctx.trace.seconds(kernels.of_kernel(kernel))
    if t <= 0:
        return None
    return 100.0 * launches * bounds.product_bound_s(
        kernel, nb, live / launches, n2) / t
