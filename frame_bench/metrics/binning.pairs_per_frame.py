"""Pairs a frame (cover pairs of a triangle and a tile or 8x8 cell) that
the binning's kernels counted on the card over the traced window: the
program's counter (``tracing.frame_counts()``), pairs over frames."""

from frame_bench import program


def read(ctx):
    counts = program.frame_counts(ctx)
    return counts["pairs"] / counts["frames"] if counts else None
