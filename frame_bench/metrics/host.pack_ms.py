"""Host milliseconds a frame in the program's span ``renderer.pack``
(``engine/renderer.py``: each frame's uniforms packed, and the batch
stacked, in NumPy) over the traced window's frames."""

from frame_bench import program


def read(ctx):
    return program.span_ms_per_unit(ctx, "renderer.pack")
