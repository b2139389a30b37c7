"""The program's ``huscf.train_steps`` span of each of the window's
epochs (it ends in the epoch's one readback), summed, over the steps
they ran, in ms: ``step_ms`` from inside the program."""
from portbench import records


def read(ctx):
    epochs = records.per_span(ctx, "train_steps")
    if epochs is None:
        return None
    spans = [r for recs in epochs
             for r in records.named(recs, "huscf.train_steps")]
    steps = sum(r.attrs["steps"] for r in spans)
    if not steps:
        return None
    return 1e3 * sum(r.seconds for r in spans) / steps
