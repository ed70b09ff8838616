"""csr_runs_ms_per_batch (ms): device time per call in building the CSR
relax's runs (frontier compaction, the ``cummax`` expansion, the runs'
stable sort): the device intervals of the program's ``csr.runs`` spans
(``repro_torch.tracing``) in the traced window, over its calls. Nothing
where the program has no such spans, or on the CPU."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None or not ctx.batches:
        return None
    ms = [s.device_ms
          for s in tracing.snapshot(clear=False).named("csr.runs")]
    if not ms or None in ms:
        return None
    return sum(ms) / ctx.batches
