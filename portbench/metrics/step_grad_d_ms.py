"""Device milliseconds of the fused step's phase ``grad_d``: from the
step's start to D's gradients (the batch draw, G's no-grad forward,
D's forward and backward on real and fake images, the server
gradients' sum). The program's ``huscf.step.grad_d`` record (CUDA
events recorded inside the step's CUDA graph, read after each epoch's
readback: the epoch's last step), averaged over the window's epochs."""
from portbench import records


def read(ctx):
    epochs = records.per_span(ctx, "train_steps")
    if epochs is None:
        return None
    ms = [r.attrs["ms"] for recs in epochs
          for r in records.named(recs, "huscf.step.grad_d")]
    return sum(ms) / len(ms) if ms else None
