"""The program's ``huscf.federate`` span of each of the window's rounds,
averaged, in ms: ``round_ms`` from inside the program, without the
benchmark's synchronisations around the call."""
from portbench import records


def read(ctx):
    rounds = records.per_span(ctx, "federate")
    if rounds is None:
        return None
    spans = [r for recs in rounds
             for r in records.named(recs, "huscf.federate")]
    return 1e3 * sum(r.seconds for r in spans) / len(spans) if spans else None
