"""``GraphPool.pool_bytes`` after the window: the device memory the
fused epochs' CUDA graph captures reserved, in GiB (off the card there
are no graphs and nothing to read)."""


def read(ctx):
    b = getattr(ctx, "counters", {}).get("graph_pool_bytes")
    return None if b is None else b / 2 ** 30
