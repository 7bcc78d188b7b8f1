"""Host milliseconds a frame in the program's span ``renderer.upload``
(``engine/renderer.py``: the uniform stack pinned and copied up without
a wait) over the traced window's frames."""

from frame_bench import program


def read(ctx):
    return program.span_ms_per_unit(ctx, "renderer.upload")
