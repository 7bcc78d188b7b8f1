"""Occupied tiles a frame (the raster's work list: 8x128 tiles on the
micro path, the tuned tile shape on the tile path) that the binning's
kernels counted on the card over the traced window: the program's counter
(``tracing.frame_counts()``), tiles over frames."""

from frame_bench import program


def read(ctx):
    counts = program.frame_counts(ctx)
    return counts["tiles"] / counts["frames"] if counts else None
