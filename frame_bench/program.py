"""What the program's own tracing gives the metrics: its spans in the
traced window (``ctx.trace.labels``, the window's ``user_annotation``
ranges, the program's beside the harness's) and its device frame counts
(``compute_renderer_torch.tracing.frame_counts()``, which count only while
a profiler session records, so exactly the traced window). A program
without them (one older than its ``tracing`` module) gives None, never an
error. Each reads only a traced window that ran on the device (a CPU
run's trace has no device operation): they are device-trace metrics."""


def on_device(ctx):
    """Whether the run has a traced window with device operations."""
    return ctx.trace is not None and bool(ctx.trace.device)


def has_tracing():
    """Whether the program has its ``tracing`` module."""
    try:
        from compute_renderer_torch import tracing  # noqa: F401
    except ImportError:
        return False
    return True


def frame_counts(ctx):
    """{"frames", "pairs", "tiles"} of the traced window, or None where
    the program counts none."""
    if not on_device(ctx):
        return None
    try:
        from compute_renderer_torch import tracing
    except ImportError:
        return None
    counts = tracing.frame_counts()
    return counts if counts["frames"] else None


def spans(ctx, name):
    """The (start, end) microseconds of the program's spans ``name`` in
    the traced window."""
    return [(s, e) for n, s, e in ctx.trace.labels if n == name]


def span_ms_per_unit(ctx, name):
    """Milliseconds of the spans ``name`` over the traced window's frames
    (or ticks), or None where there is none."""
    if not on_device(ctx) or not ctx.traced["frames"]:
        return None
    found = spans(ctx, name)
    if not found:
        return None
    return sum(e - s for s, e in found) / 1e3 / ctx.traced["frames"]
