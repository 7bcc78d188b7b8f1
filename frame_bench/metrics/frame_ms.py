"""Milliseconds a frame: the timed window's seconds over the frames it
completed (fenced in the batch loop, presented in the tick loop)."""


def read(ctx):
    r = ctx.record
    return r["seconds"] * 1e3 / r["frames"] if r["frames"] else None
