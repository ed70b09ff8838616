"""fused_pad_share (ratio): the share of the source rows the service
launched that were padding, in fused batches (up to their power-of-two
bucket) and lone ones (up to the executor's batch): the program's
``serve.pad_rows`` counter over it plus ``serve.sources`` (the valid
rows; ``repro_torch.tracing``, in ``BCService.step``) in the traced
window. Nothing where the program has no such counters, or untraced."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    c = tracing.snapshot(clear=False).counters
    if "serve.pad_rows" not in c or not c.get("serve.sources"):
        return None
    return c["serve.pad_rows"] / (c["serve.pad_rows"] + c["serve.sources"])
