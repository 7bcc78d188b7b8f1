"""The 99th percentile of the intervals between consecutive presented
frames, over every tick of the timed window (the tick loop only): the
reference's "1% low" as a percentile of all frames."""

import numpy as np


def read(ctx):
    intervals = ctx.record.get("intervals")
    if not intervals:
        return None
    return float(np.percentile(np.asarray(intervals), 99.0)) * 1e3
