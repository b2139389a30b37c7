"""Seconds from the start of the benchmark's process (the first line of
``portbench/run.py``) to the window's start: data, trainer, cut search,
weights, the checked steps, the set-up rounds, the warm epochs."""


def read(ctx):
    return ctx.setup_s
