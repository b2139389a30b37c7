"""Real images that entered the discriminator's step, summed over all
clients (clients x batch per step), over the wall time of the whole
window: from the first epoch started to the last one finished, its
rounds included (host clock)."""


def read(ctx):
    samples = ctx.window.get("samples")
    return None if samples is None else samples / ctx.window["seconds"]
