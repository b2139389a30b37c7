"""Model FLOPs of the training steps (Table 3's products of the D and
the G update, each once: ``reference.counts.step_flops_per_image``, x
clients x batch) over their summed ``train_steps`` spans, as a share of
one H100's float32 peak (67 TFLOP/s; the configuration computes in
float32 with TF32 off), in %."""
from portbench import spans as _spans
from portbench.reference import counts, peaks


def read(ctx):
    spans = _spans.pick(ctx, "train_steps")
    steps = sum(s["steps"] for s in spans)
    secs = sum(s["t1"] - s["t0"] for s in spans)
    if not steps or secs <= 0:
        return None
    flops = (counts.step_flops_per_image(ctx.config["model"])["total"]
             * ctx.clients * ctx.batch * steps)
    return 100.0 * flops / secs / peaks.FP32_FLOPS
