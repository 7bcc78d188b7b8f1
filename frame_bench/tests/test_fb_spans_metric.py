"""``raster.spans_per_frame`` (``metrics/raster.spans_per_frame.py``), on
the CPU: on a synthetic trace it reads the program's span count over the
traced frames (``tracing.frame_counts()["spans"]``), 0 where batches
added a zero word (the dense layout), and None without a trace, without
a device, where no batch added the word (a micro-path run) and at a
program without the counter; its entry in ``BENCHMARK.json`` names the
two tile-path cells."""

import sys

import pytest
import torch

from frame_bench import harness
from frame_bench.tests.test_fb_structured_tex_aniso import ctx

METRIC = "raster.spans_per_frame"
SUMS = torch.tensor([20_000, 190, 300_000], dtype=torch.int64)


def tile_words(spans):
    """A tile batch's summed accumulator words: pairs, tiles, samples,
    textured pixels, spans."""
    return torch.tensor([20_000, 190, 0, 0, spans], dtype=torch.int64)


@pytest.fixture
def tracing():
    from compute_renderer_torch import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def test_entry():
    bench = harness.load_bench()
    m = next(m for m in bench["per_layer"] if m["name"] == METRIC)
    assert m == {"name": METRIC, "unit": "spans/frame", "better": "lower",
                 "source": "device_trace", "layer": "raster",
                 "moves": "frame_ms",
                 "workloads": ["structured_tex_aniso.batch",
                               "suzanne.batch"]}


def test_reads_spans_over_frames(tracing):
    tracing.add_frames(tile_words(320), 64)
    tracing.add_frames(tile_words(64), 64)
    assert harness.read_metric(METRIC, ctx(frames=128)) == 384 / 128
    tracing.reset()
    tracing.add_frames(tile_words(0), 64)
    assert harness.read_metric(METRIC, ctx(frames=64)) == 0.0


def test_none_without_a_trace_device_or_word(tracing):
    tracing.add_frames(tile_words(5), 64)
    assert harness.read_metric(METRIC, ctx(traced=False)) is None
    assert harness.read_metric(METRIC, ctx(device=False)) is None
    tracing.reset()
    tracing.add_frames(SUMS, 64)  # no span word: the micro path
    assert harness.read_metric(METRIC, ctx()) is None


def test_none_at_a_program_without_the_counter(tracing, monkeypatch):
    # An older program's tracing: it counts four words at most and
    # frame_counts() has no "spans".
    tracing.add_frames(SUMS, 64)
    monkeypatch.setattr(tracing, "frame_counts",
                        lambda: {"frames": 64, "pairs": 20_000,
                                 "tiles": 190, "samples": 300_000})
    assert harness.read_metric(METRIC, ctx()) is None
    import compute_renderer_torch

    monkeypatch.delattr(compute_renderer_torch, "tracing")
    monkeypatch.setitem(sys.modules, "compute_renderer_torch.tracing", None)
    assert harness.read_metric(METRIC, ctx()) is None
