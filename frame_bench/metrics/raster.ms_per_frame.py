"""Device milliseconds a frame of the raster layer's kernels
(``layers/raster.json``) in the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    seconds, count = ctx.trace.device_seconds(ctx.layer("raster"))
    return seconds * 1e3 / ctx.traced["frames"] if count else None
