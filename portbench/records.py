"""The program's own spans, events and counters (``repro_torch.trace``)
for the metric readers: the recorder reached through
``portbench.program``, the module that imports the program, and its
records inside the window's benchmark spans, picked as
``portbench.spans.pick`` picks those (the epochs after the profiled
ones, or all of them where the window held no others). A program
without the recorder, or whose ring dropped records, has none: the
readers then read nothing."""
from portbench import program
from portbench import spans as _spans


def all_records():
    """Every record the program's recorder holds; None where the program
    has no recorder, or where its ring overflowed (``dropped()`` above
    0): records were lost, and a value read from the rest would be
    built from part of the run."""
    rec = getattr(program.repro_torch, "trace", None)
    if rec is None or rec.dropped() > 0:
        return None
    return rec.records()


def per_span(ctx, outer: str):
    """For each of the window's benchmark spans named ``outer``
    (``train_steps``, ``federate``), in order, the program's records
    that lie inside it; None without a recorder."""
    recs = all_records()
    if recs is None:
        return None
    out = []
    for s in sorted(_spans.pick(ctx, outer), key=lambda s: s["t0"]):
        a, b = s["t0"] * 1e9, s["t1"] * 1e9
        out.append([r for r in recs if a <= r.t0 and r.t1 <= b])
    return out


def rounds(ctx):
    """``per_span(ctx, "federate")`` of the rounds the program recorded
    (each holds its ``huscf.federate`` span); None where it recorded
    none."""
    out = [recs for recs in per_span(ctx, "federate") or ()
           if named(recs, "huscf.federate")]
    return out or None


def named(recs, name: str):
    return [r for r in recs if r.name == name]


def setup_records(ctx):
    """The records of this run's trainer: from the start of the last
    ``huscf.init.state`` span (its weight draws at construction) before
    the window's first benchmark span on. None without a recorder, or
    where the window's epochs recorded nothing or no trainer was
    built."""
    recs = all_records()
    window = [s["t0"] for s in getattr(ctx, "spans", ())]
    if recs is None or not any(named(r, "huscf.train_steps")
                               for r in per_span(ctx, "train_steps")):
        return None
    first = min(window) * 1e9
    init = [r.t0 for r in named(recs, "huscf.init.state") if r.t1 <= first]
    if not init:
        return None
    return [r for r in recs if r.t0 >= max(init)]
