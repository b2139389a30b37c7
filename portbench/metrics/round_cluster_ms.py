"""The program's ``huscf.federate.cluster`` span of each of the window's
rounds (every candidate k's k-means and silhouette, and the selection),
summed per round and averaged over the rounds, in ms."""
from portbench import records


def read(ctx):
    rounds = records.rounds(ctx)
    if rounds is None:
        return None
    return 1e3 * sum(r.seconds for recs in rounds for r in records.named(
        recs, "huscf.federate.cluster")) / len(rounds)
