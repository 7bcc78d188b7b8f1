"""Span blocks a frame of the tile raster over the traced window: where
the flat layout's scan cuts a tile's list of more than 256 triangles into
spans of 256 list positions, a block each, merged exactly, the blocks
beyond each tile's first. The program's counter
(``tracing.frame_counts()["spans"]``), spans over frames: 0 where no
list is cut (the dense layout's short lists). None off the device,
without a traced window, and where the program counts no spans (a
program older than the counter, or a run on the micro path)."""

from frame_bench import program


def read(ctx):
    counts = program.frame_counts(ctx)
    if not counts or counts.get("spans") is None:
        return None
    return counts["spans"] / counts["frames"]
