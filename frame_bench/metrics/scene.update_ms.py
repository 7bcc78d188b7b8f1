"""Host milliseconds a tick in the program's span ``scene.update``
(``engine/scene.py``: the camera uniform, the light transforms, the
effect) over the traced window's ticks."""

from frame_bench import program


def read(ctx):
    return program.span_ms_per_unit(ctx, "scene.update")
