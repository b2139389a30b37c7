"""``torch.cuda.max_memory_allocated()`` over set-up and window, after
``reset_peak_memory_stats()`` at the start, in GiB."""


def read(ctx):
    if ctx.memory_peak_bytes is None:
        return None
    return ctx.memory_peak_bytes / 2 ** 30
