"""The harness as data: every cell of BENCHMARK.json finds its
configuration, mix and limits by name, every metric its reader; a whole
run at a small size on the CPU gives the last line's schema; and the
benchmark's own entry point refuses to run without a card."""

import importlib.util
import json
import subprocess
import sys

import pytest

from frame_bench import harness
from frame_bench.reference import geometry
from frame_bench.tests import fb_small

BENCH = harness.load_bench()


@pytest.mark.parametrize("cell", [c["name"] for c in BENCH["workloads"]])
def test_cell_files_are_found_by_name(cell):
    entry = next(c for c in BENCH["workloads"] if c["name"] == cell)
    config = harness.load_json("configs", entry["config"])
    traffic = harness.load_json("traffic", entry["traffic"])
    limits = harness.load_json("limits", cell)
    assert config["name"] == entry["config"]
    assert traffic["loop"] in harness.LOOPS
    assert isinstance(limits["bad_px"], int)
    assert entry["chips"] == 1


@pytest.mark.parametrize("metric", [m["name"] for kind in
                                    ("end_to_end", "per_layer")
                                    for m in BENCH[kind]])
def test_metric_readers_are_found_by_name(metric):
    path = harness.HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    assert callable(module.read)


def test_each_cell_reports_its_metrics():
    for cell in BENCH["workloads"]:
        e2e = {m["name"] for m in harness.cell_metrics(
            BENCH, cell["name"], "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layers = harness.cell_metrics(BENCH, cell["name"], "per_layer")
        assert layers
        for m in layers:
            assert m["moves"] in e2e
            assert "layer" in m


@pytest.mark.parametrize("name", ["san_miguel", "suzanne"])
def test_configurations_build_their_triangles(name):
    config = harness.load_json("configs", name)
    pos, nrm, uvs, idx = geometry.build(config["geometry"])
    assert idx.shape[0] // 3 == config["triangles"]
    assert idx.max() < pos.shape[0]
    assert pos.shape == nrm.shape and uvs.shape == (pos.shape[0], 2)


def test_layer_lists_name_the_kernels():
    for name in ("front", "binning", "raster"):
        kernels = harness.load_json("layers", name)["kernels"]
        assert kernels and all(isinstance(k, str) for k in kernels)


@pytest.mark.parametrize("cell", ["san_miguel.batch", "san_miguel.viewer"])
@pytest.mark.parametrize("trace", [0, 1])
def test_run_gives_the_last_lines_schema(cell, trace):
    result, numbers = fb_small.run(cell, trace=trace)
    line = json.loads(json.dumps(result))
    assert set(line) >= {"correct", "attempted", "failed", "metrics",
                         "device"}
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    names = set(line["metrics"])
    if trace:
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
        assert len(line["breakdown"]["idle_gaps"]) <= 10
        # A CPU run has no device trace: only the host's spans read.
        assert names <= {"viewer.wait_ms", "viewer.flush_ms"}
    elif cell.endswith(".viewer"):
        assert names == {"frame_p99_ms", "setup_s"}
    else:
        assert names == {"frame_ms", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    assert numbers["bad_px"][0] <= numbers["bad_px"][1]


def test_run_py_refuses_without_a_card():
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "suzanne.batch", "--seed", "3000000000", "--seconds", "1",
         "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert proc.returncode != 0
    assert proc.stdout.strip() == ""
    assert "CUDA" in proc.stderr


def test_run_py_refuses_an_unknown_cell():
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "nothing.here", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_a_cell_runs_correct_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    proc = subprocess.run(
        [sys.executable, str(harness.HERE / "run.py"), "--workload",
         "suzanne.batch", "--seed", "3000000011", "--seconds", "1",
         "--trace", "1"],
        capture_output=True, text=True, timeout=1200, cwd=harness.ROOT)
    assert proc.returncode == 0, proc.stderr[-4000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["busy_s"] > 0
    assert list(line)[-1] == "check"
