"""Percent of the traced window in which no kernel, copy or set ran on the
device: 100 x (1 - union of their intervals / the window)."""


def read(ctx):
    if ctx.trace is None:
        return None
    busy, window = ctx.trace.busy_s(), ctx.trace.window_s()
    if busy <= 0.0 or window <= 0.0:
        return None
    return 100.0 * (1.0 - busy / window)
