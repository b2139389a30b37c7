"""Device values the program read on the host in one round (its
``huscf.readback`` events: k-means++ seeds, each Lloyd iteration's
convergence test and empty-cluster re-seeds, each candidate's
silhouette check, the selection): the count of the window's median
round (the lower of the two middle ones), a whole number."""
import statistics

from portbench import records


def read(ctx):
    rounds = records.rounds(ctx)
    if rounds is None:
        return None
    return statistics.median_low(
        len(records.named(recs, "huscf.readback")) for recs in rounds)
