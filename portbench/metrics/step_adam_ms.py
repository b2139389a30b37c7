"""Device milliseconds of the fused step's two Adam updates and
BatchNorm merges (the program's ``huscf.step.adam_d`` and
``huscf.step.adam_g`` records: CUDA events recorded inside the step's
CUDA graph, read after each epoch's readback, the epoch's last step),
each averaged over the window's epochs, summed."""
from portbench import records


def read(ctx):
    epochs = records.per_span(ctx, "train_steps")
    if epochs is None:
        return None
    ms = [[r.attrs["ms"] for recs in epochs
           for r in records.named(recs, "huscf.step." + p)]
          for p in ("adam_d", "adam_g")]
    if not all(ms):
        return None
    return sum(sum(x) / len(x) for x in ms)
