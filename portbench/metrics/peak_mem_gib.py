"""peak_mem_gib (GiB): the device memory peak inside the window
(``torch.cuda.max_memory_allocated()`` after a reset at its start)."""


def read(ctx):
    if not ctx.peak_window_bytes:
        return None
    return ctx.peak_window_bytes / 2 ** 30
