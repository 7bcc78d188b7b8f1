"""Device operations (kernels, copies and sets) a frame in the traced
window: the count ``profile_batch`` of the port's ``bench/profiling.py``
makes."""


def read(ctx):
    if ctx.trace is None or not ctx.traced["frames"]:
        return None
    _, count = ctx.trace.device_seconds()
    return count / ctx.traced["frames"] if count else None
