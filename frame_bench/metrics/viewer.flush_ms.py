"""Mean milliseconds of a flush tick's ``flush_overflow()`` (and the
checked render where it found an overflow) over the timed window: the
harness's own host span."""

import numpy as np


def read(ctx):
    flushes = ctx.record.get("flushes")
    return float(np.mean(flushes)) * 1e3 if flushes else None
