"""host_syncs_per_batch (count): device-to-host reads per call on the batch
path (the sweeps' counts, a relax's own count read, the results' copies):
the program's ``host_syncs`` counter (``repro_torch.tracing``) in the
traced window, over its calls. Nothing where the program has no such
counter, or on the CPU (no ``batch`` span with a device interval)."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None or not ctx.batches:
        return None
    snap = tracing.snapshot(clear=False)
    batches = snap.named("batch")
    if (not batches or any(s.device_ms is None for s in batches)
            or "host_syncs" not in snap.counters):
        return None
    return snap.counters["host_syncs"] / ctx.batches
