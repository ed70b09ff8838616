"""stop_check_ms_per_batch (ms): host time per executor batch in the
service's epoch-boundary stopping checks, while the card waits: the
program's ``serve.stop_check`` spans (``repro_torch.tracing``, in
``BCService.step``) in the traced window, their host ms summed over the
window's ``batch`` spans. Nothing where the program has no such spans
(no ``serve.tick``), untraced, or without batches."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    snap = tracing.snapshot(clear=False)
    batches = snap.named("batch")
    if not batches or not snap.named("serve.tick"):
        return None
    return sum(s.host_ms for s in snap.named("serve.stop_check")) / len(
        batches)
