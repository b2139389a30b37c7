"""Seconds of the program's ``huscf.graphs.capture`` spans (each CUDA
graph capture of the fused epoch, to its synchronisation), summed over
this run from its trainer's construction on (0 where nothing was
captured: the CPU)."""
from portbench import records


def read(ctx):
    recs = records.setup_records(ctx)
    if recs is None:
        return None
    return sum(r.seconds for r in records.named(recs, "huscf.graphs.capture"))
