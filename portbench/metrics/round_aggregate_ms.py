"""The program's ``huscf.federate.aggregate`` spans of each of the
window's rounds (one per net: the weight matrix, the flat buffer, kernel
K1 and the copies back), summed per round and averaged over the rounds,
in ms."""
from portbench import records


def read(ctx):
    rounds = records.rounds(ctx)
    if rounds is None:
        return None
    return 1e3 * sum(r.seconds for recs in rounds for r in records.named(
        recs, "huscf.federate.aggregate")) / len(rounds)
