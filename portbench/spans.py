"""Span selection shared by the metric readers of spans: the traced
run's spans of the epochs after the profiled ones, or all of them where
the window held no others (none where the cell's driver keeps no
spans)."""


def pick(ctx, name):
    mine = [s for s in getattr(ctx, "spans", ()) if s["name"] == name]
    rest = [s for s in mine if not s["profiled"]]
    return rest or mine
