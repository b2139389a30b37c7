"""The benchmark's span around each ``federate`` call of the traced run
(the card synchronised before and after), in ms per round."""
from portbench import spans as _spans


def read(ctx):
    spans = _spans.pick(ctx, "federate")
    if not spans:
        return None
    return 1e3 * sum(s["t1"] - s["t0"] for s in spans) / len(spans)
