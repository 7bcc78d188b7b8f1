"""The longest tile list of any frame in the traced window, in triangles:
the list that the tile raster's last block walks, since the raster runs
one block a tile and a frame ends with its longest tile. The program's
peak (``tracing.frame_peaks()["list"]``): the binning's scan kernels fold
the largest bin count of each frame, before any cap, into the batch's
accumulator by max, and a recorded batch folds it into the peak. None
off the device, without a traced window, and where the program keeps no
such peak (a program older than it, or one that recorded none)."""

from frame_bench import program


def read(ctx):
    if not program.on_device(ctx) or not ctx.traced["frames"]:
        return None
    try:
        from compute_renderer_torch import tracing
    except ImportError:
        return None
    peaks = getattr(tracing, "frame_peaks", None)
    if peaks is None:
        return None
    return peaks().get("list")
