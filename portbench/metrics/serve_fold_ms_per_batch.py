"""serve_fold_ms_per_batch (ms): host time per executor batch in the
service's folds, each batch's moments scattered to its slots and added
into their estimators' float64 sums: the program's ``serve.fold`` spans
(``repro_torch.tracing``, in ``BCService.step``) in the traced window,
their host ms summed over the window's ``batch`` spans. Nothing where the
program has no such spans, untraced, or without batches."""


def read(ctx):
    try:
        from repro_torch import tracing
    except ImportError:
        return None
    if ctx.trace is None:
        return None
    snap = tracing.snapshot(clear=False)
    batches = snap.named("batch")
    folds = snap.named("serve.fold")
    if not batches or not folds:
        return None
    return sum(s.host_ms for s in folds) / len(batches)
