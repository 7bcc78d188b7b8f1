"""Coverage samples a frame that the micro raster tested on the card over
the traced window (its cull keeps a pair's 2x2 quads that it may cover,
and only their samples are tested; a pair walked whole counts 64): the
program's counter (``tracing.frame_counts()["samples"]``), samples over
frames. None where the program counts no samples."""

from frame_bench import program


def read(ctx):
    counts = program.frame_counts(ctx)
    if not counts or counts.get("samples") is None:
        return None
    return counts["samples"] / counts["frames"]
