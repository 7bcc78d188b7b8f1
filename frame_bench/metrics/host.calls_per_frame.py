"""The host's CUDA calls that issue device work (kernel and graph launches,
copies, sets) a frame in the traced window, per-batch and per-tick calls
included."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["frames"] or not ctx.trace.calls:
        return None
    return len(ctx.trace.calls) / ctx.traced["frames"]
