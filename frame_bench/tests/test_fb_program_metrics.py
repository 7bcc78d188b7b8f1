"""The readers of the program's own spans and counters, on synthetic
traces: the host stages' milliseconds a frame, the scene update's a tick,
the captures in the window, the pairs and occupied tiles a frame from
``tracing.frame_counts()`` and the bin sort's roofline share; each reads
None where the program has no such span or counter, or the trace no
device operation."""

import sys

import pytest
import torch

from frame_bench import harness, trace

WINDOW = "frame_bench.window"


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic(device=True, captures=0):
    # A 1000 us window of two batches: pack, upload and replay spans, a
    # scene update, the bin sort's three kernels (6 us in all) and one
    # span that starts after the window.
    events = [
        ev(WINDOW, "user_annotation", 0.0, 1000.0),
        ev("frame_bench.submit", "user_annotation", 10.0, 400.0),
        ev("renderer.pack", "user_annotation", 20.0, 30.0),
        ev("renderer.upload", "user_annotation", 50.0, 10.0),
        ev("renderer.replay", "user_annotation", 60.0, 300.0),
        ev("renderer.pack", "user_annotation", 420.0, 50.0),
        ev("renderer.upload", "user_annotation", 470.0, 10.0),
        ev("renderer.replay", "user_annotation", 480.0, 300.0),
        ev("scene.update", "user_annotation", 800.0, 40.0),
        ev("renderer.pack", "user_annotation", 1200.0, 50.0),
    ]
    events += [ev("renderer.capture", "user_annotation", 850.0 + 10 * i,
                  5.0) for i in range(captures)]
    if device:
        events += [
            ev("_anonymous_namespace_::bin_sort_hist_kernel(int const*)",
               "kernel", 100.0, 1.0),
            ev("_anonymous_namespace_::bin_sort_scan_kernel(int*)",
               "kernel", 101.0, 2.0),
            ev("_anonymous_namespace_::bin_sort_place_kernel(int const*)",
               "kernel", 103.0, 3.0),
            ev("void micro_kernel<0>(Frame)", "kernel", 106.0, 20.0),
        ]
    return {"traceEvents": events}


def ctx(frames=4, **kw):
    config = {"width": 1024, "height": 768, "triangles": 1000,
              "shading": "base"}
    return harness.Context(config, {"frames": 0}, 1.0,
                           trace.Trace(synthetic(**kw), WINDOW),
                           {"frames": frames})


@pytest.fixture
def counts():
    """The program's frame counts set to 4 frames, 1,000,000 pairs and
    3,000 tiles; cleared after."""
    from compute_renderer_torch import tracing

    tracing.reset()
    tracing.add_frames(torch.tensor([600_000, 1_000], dtype=torch.int64), 2)
    tracing.add_frames(torch.tensor([400_000, 2_000], dtype=torch.int64), 2)
    yield tracing.frame_counts()
    tracing.reset()


def test_host_stage_spans_a_frame():
    c = ctx(frames=4)
    # The span past the window is not counted.
    assert harness.read_metric("host.pack_ms", c) == pytest.approx(0.02)
    assert harness.read_metric("host.upload_ms", c) == pytest.approx(0.005)
    assert harness.read_metric("host.replay_ms", c) == pytest.approx(0.15)
    assert harness.read_metric("scene.update_ms", c) == pytest.approx(0.01)


def test_captures_count_zero_when_none():
    assert harness.read_metric("renderer.captures", ctx()) == 0
    assert harness.read_metric("renderer.captures", ctx(captures=2)) == 2


def test_frame_counts_a_frame(counts):
    assert counts == {"frames": 4, "pairs": 1_000_000, "tiles": 3_000}
    c = ctx()
    assert harness.read_metric("binning.pairs_per_frame", c) == 250_000
    assert harness.read_metric("raster.tiles_per_frame", c) == 750


def test_bin_sort_roofline(counts):
    # 250,000 pairs a frame at 12 B, 12,288 cells at 8 B, 768 tiles at
    # 12 B and 20 B, over 3.35 TB/s, against 6 us over 4 frames.
    nbytes = 250_000 * 12 + 12_288 * 8 + 768 * 12 + 20
    want = 100.0 * (nbytes / 3.35e12) / (6e-6 / 4)
    assert harness.read_metric("bin_sort_roofline", ctx()) == \
        pytest.approx(want)
    assert 4.0 < harness.read_metric("bin_sort_roofline", ctx()) < 100.0


def test_nothing_without_a_device_trace(counts):
    c = ctx(device=False)
    for name in ("host.pack_ms", "host.upload_ms", "host.replay_ms",
                 "scene.update_ms", "renderer.captures",
                 "binning.pairs_per_frame", "raster.tiles_per_frame",
                 "bin_sort_roofline"):
        assert harness.read_metric(name, c) is None, name
    untraced = harness.Context({}, {"frames": 10, "seconds": 1.0}, 1.0)
    assert harness.read_metric("renderer.captures", untraced) is None


def test_nothing_from_a_program_without_tracing(monkeypatch):
    # A program older than its tracing module (the parent of the change
    # that added it): the counters and captures read None, never raise;
    # a trace without its spans reads None too.
    import compute_renderer_torch

    monkeypatch.delattr(compute_renderer_torch, "tracing")
    monkeypatch.setitem(sys.modules, "compute_renderer_torch.tracing", None)
    c = ctx()
    for name in ("renderer.captures", "binning.pairs_per_frame",
                 "raster.tiles_per_frame", "bin_sort_roofline"):
        assert harness.read_metric(name, c) is None, name
    bare = harness.Context({}, {"frames": 0}, 1.0, trace.Trace(
        {"traceEvents": [ev(WINDOW, "user_annotation", 0.0, 10.0),
                         ev("k", "kernel", 1.0, 1.0)]}, WINDOW),
        {"frames": 1})
    assert harness.read_metric("host.pack_ms", bare) is None


def test_no_counts_read_none():
    from compute_renderer_torch import tracing

    tracing.reset()
    assert harness.read_metric("binning.pairs_per_frame", ctx()) is None
    assert harness.read_metric("bin_sort_roofline", ctx()) is None


def test_bin_sort_layer_names_its_kernels():
    kernels = harness.load_json("layers", "bin_sort")["kernels"]
    assert kernels == ["bin_sort_hist_kernel", "bin_sort_scan_kernel",
                       "bin_sort_place_kernel"]
    assert set(kernels) <= set(harness.load_json("layers",
                                                 "binning")["kernels"])
