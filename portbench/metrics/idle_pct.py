"""idle_pct (%): the share of the traced window in which no operation ran
on the card: 100 · (1 - union of the operations' intervals / the
window)."""


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)
