"""The benchmark's span around each ``train_steps`` call of the traced
run (the card synchronised before it; it ends in the epoch's readback),
summed, over the steps they ran, in ms."""
from portbench import spans as _spans


def read(ctx):
    spans = _spans.pick(ctx, "train_steps")
    steps = sum(s["steps"] for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / steps
