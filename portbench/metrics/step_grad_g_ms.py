"""Device milliseconds of the fused step's phase ``grad_g``: from D's
update to G's gradients (G's forward, D's forward on the fakes, the
backward through both). The program's ``huscf.step.grad_g`` record
(CUDA events recorded inside the step's CUDA graph, read after each
epoch's readback: the epoch's last step), averaged over the window's
epochs."""
from portbench import records


def read(ctx):
    epochs = records.per_span(ctx, "train_steps")
    if epochs is None:
        return None
    ms = [r.attrs["ms"] for recs in epochs
          for r in records.named(recs, "huscf.step.grad_g")]
    return sum(ms) / len(ms) if ms else None
