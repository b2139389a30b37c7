"""Host time from the end of one epoch's readback (the program's
``huscf.train_steps.readback`` span) to the start of the next epoch's
first launch (``huscf.train_steps.launch``), averaged over the window's
pairs of consecutive epochs with no round between them, in ms: the
time the card has nothing queued between two epochs."""
from portbench import records, spans


def read(ctx):
    epochs = records.per_span(ctx, "train_steps")
    if epochs is None:
        return None
    outer = sorted(spans.pick(ctx, "train_steps"), key=lambda s: s["t0"])
    rounds = [(s["t0"], s["t1"]) for s in getattr(ctx, "spans", ())
              if s["name"] == "federate"]
    gaps = []
    for (a, ra), (b, rb) in zip(zip(outer, epochs),
                                zip(outer[1:], epochs[1:])):
        if any(a["t1"] <= r0 and r1 <= b["t0"] for r0, r1 in rounds):
            continue
        back = records.named(ra, "huscf.train_steps.readback")
        launch = records.named(rb, "huscf.train_steps.launch")
        if back and launch:
            gaps.append(min(r.t0 for r in launch) - max(r.t1 for r in back))
    return 1e-6 * sum(gaps) / len(gaps) if gaps else None
