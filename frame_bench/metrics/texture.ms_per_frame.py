"""Device milliseconds a frame of the texture layer's kernels
(``layers/texture.json``: the mip rows, the fused tails, the deferred tail
and its vertex stage) in the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    seconds, count = ctx.trace.device_seconds(ctx.layer("texture"))
    return seconds * 1e3 / ctx.traced["frames"] if count else None
