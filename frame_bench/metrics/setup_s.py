"""Seconds from the process's start to the first timed frame: imports,
the geometry, the renderer, and set-up's pass over the path (the first
run in a checkout also builds the kernels)."""


def read(ctx):
    return ctx.setup_s
