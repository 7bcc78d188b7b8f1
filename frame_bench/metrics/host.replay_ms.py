"""Host milliseconds a frame in the program's span ``renderer.replay``
(``engine/renderer.py``: a batch's loop of copy in, graph launch and
copy out, one span a batch) over the traced window's frames."""

from frame_bench import program


def read(ctx):
    return program.span_ms_per_unit(ctx, "renderer.replay")
