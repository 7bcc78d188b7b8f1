"""Mean milliseconds a tick spent in ``FramePipe.fetch`` (the tick's one
wait for the frame before it) over the timed window: the harness's own
host span."""

import numpy as np


def read(ctx):
    waits = ctx.record.get("waits")
    return float(np.mean(waits)) * 1e3 if waits else None
