"""The reader of the micro raster's tested samples a frame
(``raster.samples_per_frame``): samples over frames from the program's
``tracing.frame_counts()``; None where the program counts no samples (a
program older than the counter, or counts added without them), where the
trace has no device operation, or where nothing was counted."""

import sys

import pytest
import torch

from frame_bench import harness
from frame_bench.tests.test_fb_program_metrics import ctx

NAME = "raster.samples_per_frame"


@pytest.fixture
def tracing():
    from compute_renderer_torch import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def test_samples_a_frame(tracing):
    tracing.add_frames(torch.tensor([600_000, 1_000, 3_600_000],
                                    dtype=torch.int64), 2)
    tracing.add_frames(torch.tensor([400_000, 2_000, 2_400_000],
                                    dtype=torch.int64), 2)
    assert harness.read_metric(NAME, ctx()) == 1_500_000
    # The pairs and tiles are read as before beside it.
    assert harness.read_metric("binning.pairs_per_frame", ctx()) == 250_000


def test_zero_samples_read_zero(tracing):
    # A traced window whose frames tested none (the tile path adds none).
    tracing.add_frames(torch.tensor([1_000, 10, 0], dtype=torch.int64), 4)
    assert harness.read_metric(NAME, ctx()) == 0


def test_none_without_the_samples_key(tracing):
    # Counts added without samples, as from a program whose accumulator
    # has no samples word: frame_counts() has no "samples".
    tracing.add_frames(torch.tensor([1_000, 10], dtype=torch.int64), 4)
    assert "samples" not in tracing.frame_counts()
    assert harness.read_metric(NAME, ctx()) is None
    assert harness.read_metric("binning.pairs_per_frame", ctx()) == 250


def test_none_at_a_program_whose_counts_lack_samples(monkeypatch):
    # The parent of the change that added the counter: its frame_counts()
    # is {"frames", "pairs", "tiles"}, passed through unchanged.
    from frame_bench import program

    monkeypatch.setattr(program, "frame_counts", lambda c: {
        "frames": 4, "pairs": 1_000, "tiles": 40})
    assert harness.read_metric(NAME, ctx()) is None


def test_none_without_a_device_trace_or_counts(tracing):
    tracing.add_frames(torch.tensor([1_000, 10, 6_000], dtype=torch.int64),
                       4)
    assert harness.read_metric(NAME, ctx(device=False)) is None
    tracing.reset()
    assert harness.read_metric(NAME, ctx()) is None


def test_none_from_a_program_without_tracing(monkeypatch):
    import compute_renderer_torch

    monkeypatch.delattr(compute_renderer_torch, "tracing")
    monkeypatch.setitem(sys.modules, "compute_renderer_torch.tracing", None)
    assert harness.read_metric(NAME, ctx()) is None


def test_listed_for_the_micro_batch_cell_alone():
    entry = next(m for m in harness.load_bench()["per_layer"]
                 if m["name"] == NAME)
    assert entry["workloads"] == ["san_miguel.batch"]
    assert (entry["layer"], entry["moves"], entry["unit"]) == (
        "raster", "frame_ms", "samples/frame")
