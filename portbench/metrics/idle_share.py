"""The device's idle share over the traced part of the window: 1 - the
union of its activities' intervals (``torch.profiler``) over the part's
wall time, in %."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
