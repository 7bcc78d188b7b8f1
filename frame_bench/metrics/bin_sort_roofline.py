"""The bin sort's share of its roofline on the micro path: the least time
its compulsory bytes take at the HBM rate (``peaks.json``) over its three
kernels' time a frame (``layers/bin_sort.json``) in the traced window, in
percent.

Bytes a frame (``chip_smoke.py`` ``sort_bound``, frozen here for the
micro layout): 12 B a valid slot (a pair's key and triangle read, its
triangle written), 8 B a bin (an 8x8 cell's segment start and count), 12
B a micro tile (an 8x128 tile's count, window base and work-list entry),
and 20 B of totals; the pairs a frame are the program's counter
(``tracing.frame_counts()``). San Miguel at 1024x768: 12,288 cells, 768
tiles."""

from frame_bench import program

SLOT_BYTES = 12
BIN_BYTES = 8
TILE_BYTES = 12
TOTAL_BYTES = 4 + 16


def read(ctx):
    counts = program.frame_counts(ctx)
    if counts is None or not ctx.traced["frames"]:
        return None
    seconds, n = ctx.trace.device_seconds(ctx.layer("bin_sort"))
    if not n or seconds <= 0.0:
        return None
    W, H = ctx.config["width"], ctx.config["height"]
    tiles = ((W + 127) // 128) * ((H + 7) // 8)
    nbytes = (counts["pairs"] / counts["frames"] * SLOT_BYTES
              + 16 * tiles * BIN_BYTES + tiles * TILE_BYTES + TOTAL_BYTES)
    bound = nbytes / ctx.peaks()["hbm_bytes_per_s"]
    return 100.0 * bound / (seconds / ctx.traced["frames"])
