"""The reduction of a trace to the per-layer metrics, on synthetic
profiler events: the busy union and idle share, device operations and
host calls a frame, a layer's milliseconds, the front's roofline share,
and the breakdown."""

import pytest

from frame_bench import harness, trace

WINDOW = "frame_bench.window"


def ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def synthetic():
    # A 100 us window; kernels overlap at 10-30 and 25-40 (busy 30), a
    # copy at 60-70 (busy 10), one kernel starts after the window.
    return {"traceEvents": [
        ev(WINDOW, "user_annotation", 0.0, 100.0),
        ev("void front_kernel<0>(float const*)", "kernel", 10.0, 20.0),
        ev("bin_sort_place_kernel", "kernel", 25.0, 15.0),
        ev("Memcpy DtoD (Device -> Device)", "gpu_memcpy", 60.0, 10.0),
        ev("void micro_kernel<0>(Frame)", "kernel", 120.0, 5.0),
        ev("cudaGraphLaunch", "cuda_runtime", 5.0, 2.0),
        ev("cudaMemcpyAsync", "cuda_runtime", 44.0, 2.0),
        ev("cudaEventRecord", "cuda_runtime", 52.0, 1.0),
        ev("cudaLaunchKernel", "cuda_runtime", 130.0, 1.0),
        ev("frame_bench.fence", "user_annotation", 40.0, 20.0),
        ev("frame_bench.submit", "user_annotation", 70.0, 30.0),
    ]}


def ctx(frames=2, triangles=1000):
    t = trace.Trace(synthetic(), WINDOW)
    config = {"triangles": triangles, "shading": "base"}
    return harness.Context(config, {"frames": 0}, 1.0, t,
                           {"frames": frames})


def test_union_and_gaps():
    assert trace.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert trace.union_length([]) == 0
    assert trace.gaps([(1, 2), (4, 9)], 0, 10) == [(0, 1), (2, 4), (9, 10)]


def test_busy_window_and_idle():
    c = ctx()
    assert c.trace.window_s() == pytest.approx(100e-6)
    assert c.trace.busy_s() == pytest.approx(40e-6)
    assert harness.read_metric("device.idle_pct", c) == pytest.approx(60.0)


def test_counts_a_frame():
    c = ctx(frames=2)
    # Three device operations and two launching calls in the window (the
    # event record issues no device work).
    assert harness.read_metric("device.kernels_per_frame", c) == 1.5
    assert harness.read_metric("host.calls_per_frame", c) == 1.0


def test_layer_times():
    c = ctx(frames=2)
    assert harness.read_metric("front.ms_per_frame", c) == pytest.approx(
        0.01)
    assert harness.read_metric("binning.ms_per_frame", c) == pytest.approx(
        0.0075)
    # The raster's kernel lies outside the window: nothing to read.
    assert harness.read_metric("raster.ms_per_frame", c) is None


def test_front_roofline():
    c = ctx(frames=2, triangles=1000)
    # 216 B a triangle over 3.35 TB/s, against 10 us a frame.
    want = 100.0 * (1000 * 216 / 3.35e12) / 10e-6
    assert harness.read_metric("front_roofline", c) == pytest.approx(want)
    assert 72 + 32 * 4 + 16 == 216


def test_untraced_run_reads_no_layer():
    c = harness.Context({}, {"frames": 10, "seconds": 2.0}, 3.0)
    for name in ("device.idle_pct", "front.ms_per_frame",
                 "front_roofline", "host.calls_per_frame"):
        assert harness.read_metric(name, c) is None
    assert harness.read_metric("frame_ms", c) == 200.0
    assert harness.read_metric("setup_s", c) == 3.0
    assert harness.read_metric("frame_p99_ms", c) is None


def test_tick_window_metrics():
    record = {"frames": 4, "seconds": 0.004,
              "intervals": [0.001] * 99 + [0.011],
              "waits": [0.0002, 0.0004], "flushes": [0.003]}
    c = harness.Context({}, record, 1.0)
    assert harness.read_metric("frame_p99_ms", c) == pytest.approx(
        1.1)
    assert harness.read_metric("viewer.wait_ms", c) == pytest.approx(0.3)
    assert harness.read_metric("viewer.flush_ms", c) == pytest.approx(3.0)


def test_breakdown():
    b = ctx().trace.breakdown()
    assert b["device_ops"][0][0].startswith("void front_kernel")
    gaps = dict(b["idle_gaps"])
    # 0-10 under no range, 40-60 under the fence, 70-100 under submit.
    assert gaps["frame_bench.fence"] == pytest.approx(20e-6)
    assert gaps["frame_bench.submit"] == pytest.approx(30e-6)
    assert sum(gaps.values()) == pytest.approx(60e-6)
