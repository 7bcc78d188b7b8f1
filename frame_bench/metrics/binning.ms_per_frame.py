"""Device milliseconds a frame of the binning layer's kernels
(``layers/binning.json``) in the traced window."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    seconds, count = ctx.trace.device_seconds(ctx.layer("binning"))
    return seconds * 1e3 / ctx.traced["frames"] if count else None
