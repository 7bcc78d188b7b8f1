"""Graph captures in the traced window: the program's spans
``renderer.capture`` (``Renderer._capture``). A capture there is a tail
event of milliseconds (an overflow's capacity growth drops the graphs);
0 where there is none, None where the program has no such span."""

from frame_bench import program


def read(ctx):
    if not program.on_device(ctx) or not program.has_tracing():
        return None
    return len(program.spans(ctx, "renderer.capture"))
