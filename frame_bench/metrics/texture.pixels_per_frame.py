"""Pixels a frame that the mip texture tail shaded from an image (covered,
and the winner's triangle textured) on the card over the traced window:
the program's counter (``tracing.frame_counts()["textured"]``), pixels
over frames. None where the program counts no textured pixels (a program
older than the counter, or frames that ran no mip texture tail)."""

from frame_bench import program


def read(ctx):
    counts = program.frame_counts(ctx)
    if not counts or counts.get("textured") is None:
        return None
    return counts["textured"] / counts["frames"]
