"""child_count_ms_per_batch (ms): device time per call in the SP-DAG child
count, dense or COO form: the device intervals of the program's
``child_count`` spans (``repro_torch.tracing``) in the traced window, over
its calls. Nothing where the program has no such spans, or on the CPU."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None or not ctx.batches:
        return None
    ms = [s.device_ms
          for s in tracing.snapshot(clear=False).named("child_count")]
    if not ms or None in ms:
        return None
    return sum(ms) / ctx.batches
