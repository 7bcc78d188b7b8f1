"""The textured 36k configuration under anisotropic filtering
(``configs/structured_tex_aniso.json``), its cell and the longest tile
list's metric, on the CPU:

- the configuration as its file states it, and its entries in
  ``BENCHMARK.json``;
- a small version of it (512x384 frames, a 256-texel ground, so that
  the far ground minifies and the lods leave level 0, on the tile path
  at 8x128 tiles, the tuner's second shape: at a smaller frame or at
  16x256 a tile's list outgrows the tile cap and the renderer falls
  back to the micro path) through the harness reads ``correct``, and
  reads not correct with the program's filter forced to ``trilinear`` or
  with the bfloat16 control in its place;
- the port's renderer on that tile path equals the reference within the
  cell's limit under seeded random poses of the cell's path,
  counts the reference's textured pixels, and reports as its longest
  tile list (``tracing.frame_peaks()["list"]``) the largest count of any
  frame's tiles, counted directly from the rects the binning was given;
- ``raster.longest_list`` on a synthetic trace gives the program's peak,
  and None without a trace, without a device, and at a program without
  the reading."""

import copy
import sys

import numpy as np
import pytest
import torch

from frame_bench import harness, trace
from frame_bench.reference import camera as cam
from frame_bench.reference import objscene
from frame_bench.reference import render as ref
from frame_bench.tests import fb_small
from frame_bench.tests.test_fb_structured_trilinear import (
    control_in_place,
)

CONFIG = "structured_tex_aniso"
CELL = "structured_tex_aniso.batch"
W, H = 512, 384
# The tile path, at the tuner's 8x128 (the longest list at 512x384 is
# about 3,500 triangles, against 7,300 at 16x256 and the cap's 8,192).
TILE = {"path": "tile", "tile_h": 8, "tile_w": 128}
# The small run's limit, as test_fb_structured_trilinear.py's: between
# the program's reading (0 at this size) and the faults' and the
# control's.
SMALL_BAD_PX = 100
METRIC = "raster.longest_list"
JOINED = ("frame_ms", "device.idle_pct", "device.kernels_per_frame",
          "host.calls_per_frame", "host.pack_ms", "host.upload_ms",
          "host.replay_ms", "front.ms_per_frame", "binning.ms_per_frame",
          "binning.pairs_per_frame", "raster.ms_per_frame",
          "raster.tiles_per_frame", "texture.ms_per_frame",
          "texture.pixels_per_frame", "front_mip_roofline",
          "mip_rows_roofline", "texture_tail_roofline")
# The micro layout's and the base mode's readers.
NOT_JOINED = ("bin_sort_roofline", "raster.samples_per_frame",
              "front_roofline")


def small_config():
    """The configuration at 512x384 with a 256-texel ground and a
    64-texel marble image."""
    cfg = copy.deepcopy(harness.load_json("configs", CONFIG))
    cfg["width"], cfg["height"] = W, H
    cfg["geometry"][0].update(ground_px=256, marble_px=64)
    return cfg


def short_mix(mix):
    mix.update(batch=4)
    mix["camera"]["period_s"] = 0.25


def on_the_tile_path(monkeypatch):
    """The program's renderers on the small version's tile path; returns
    the list of those made."""
    from compute_renderer_torch.engine.scene import Scene

    orig, made = Scene.renderer_options, []

    def tiled(self):
        made.append(self)
        return dict(orig(self), **TILE)

    monkeypatch.setattr(Scene, "renderer_options", tiled)
    return made


def run_small(monkeypatch, **kwargs):
    made = on_the_tile_path(monkeypatch)
    out = fb_small.run(CELL, cfg=small_config(), traffic_changes=short_mix,
                       bad_px=SMALL_BAD_PX, **kwargs)
    assert len(made) == 1
    return out


# --------------------------------------------------------------------------
# The configuration and its entries
# --------------------------------------------------------------------------

def test_configuration_file():
    cfg = harness.load_json("configs", CONFIG)
    assert (cfg["shading"], cfg["tex_filter"]) == ("textures", "anisotropic")
    assert (cfg["width"], cfg["height"], cfg["cell"]) == (1024, 768, 8)
    assert cfg["lights"] == harness.load_json("configs", "san_miguel")[
        "lights"]
    assert cfg["camera"] == {"spawn": [13.566635, 4.0, 24.0],
                             "interactive": "walk"}
    assert cfg["geometry"] == [{
        "kind": objscene.KIND, "terrain_n": 120, "statue_nu": 80,
        "statue_nv": 44, "ruins": 40, "size": 60.0, "mtl": "structured_tex",
        "ground_px": 4096, "marble_px": 1024}]
    assert cfg["reduced"] == [] and len(cfg["assumed"]) >= 3
    p = cfg["geometry"][0]
    assert (2 * p["terrain_n"] ** 2 + 2 * p["statue_nu"] * p["statue_nv"]
            + 12 * p["ruins"] + 2) == cfg["triangles"] == 36322
    # Below the micro path's split: the cell renders on the tile path.
    from compute_renderer_torch.backends import cuda

    assert cuda.resolve_path("auto", cfg["triangles"]) == "tile"


def test_generator_counts():
    # 18,610 vertices ((120 + 1)^2 terrain, 81 x 45 statue, 8 a ruin, 4
    # banner) and 35,840 textured faces (the terrain's and the statue's),
    # at small images: the counts do not depend on them.
    cfg = small_config()
    cfg["geometry"][0].update(ground_px=8, marble_px=8)
    arrays = harness.build_scene(cfg)
    arrays.remove_files()
    assert arrays.tri.shape == (36322, 3)
    assert arrays.positions.shape == (18610, 3)
    assert int((arrays.face_image >= 0).sum()) == 35840
    # mip_rows_roofline's frozen 46 B a triangle holds here within 0.5%.
    per_triangle = 36 + 20 * 18610 / 36322
    assert abs(per_triangle - 46) / 46 < 0.006


def test_benchmark_entries():
    # Membership, not position: later cells and metrics are appended.
    bench = harness.load_bench()
    config = next(c for c in bench["configs"] if c["name"] == CONFIG)
    cfg = harness.load_json("configs", CONFIG)
    assert config["file"] == f"frame_bench/configs/{CONFIG}.json"
    assert config["source"] == cfg["source"] and config["reduced"] == []
    cell = next(c for c in bench["workloads"] if c["name"] == CELL)
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        CONFIG, "batch", 1)
    listed = {m["name"]: m for kind in ("end_to_end", "per_layer")
              for m in bench[kind]}
    for name in JOINED:
        assert CELL in listed[name]["workloads"], name
    for name in NOT_JOINED:
        assert CELL not in listed[name]["workloads"], name
    m = listed[METRIC]
    assert m == {"name": METRIC, "unit": "triangles", "better": "lower",
                 "source": "device_trace", "layer": "raster",
                 "moves": "frame_ms",
                 "workloads": [CELL, "suzanne.batch"]}
    assert isinstance(harness.load_json("limits", CELL)["bad_px"], int)


# --------------------------------------------------------------------------
# The small run, its faults and the control
# --------------------------------------------------------------------------

def test_small_run_is_correct(monkeypatch):
    result, numbers = run_small(monkeypatch)
    assert result["correct"] is True, numbers
    assert numbers["bad_px"][0] == 0
    assert result["attempted"] > 0


def trilinear_filter(monkeypatch):
    from compute_renderer_torch.engine.scene import Scene

    orig = Scene.renderer_options

    def broken(self):
        return dict(orig(self), tex_filter="trilinear")

    monkeypatch.setattr(Scene, "renderer_options", broken)


def small_control(monkeypatch):
    from frame_bench.tests import test_fb_structured_trilinear as tri

    monkeypatch.setattr(tri, "small_config", small_config)
    control_in_place(monkeypatch)


@pytest.mark.parametrize("fault", [trilinear_filter, small_control])
def test_small_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, numbers = run_small(monkeypatch)
    assert result["correct"] is False, numbers
    assert numbers["bad_px"][0] > numbers["bad_px"][1]


# --------------------------------------------------------------------------
# The tile path against the reference: frames, texels and the longest list
# --------------------------------------------------------------------------

def reference_textured(scene, vpos, vp, cell):
    """The reference's covered pixels whose winning triangle has an
    image: its depth resolve, then each winner's ``face_image``."""
    screen = ref._screen(scene, vp, W, H, torch.float32)
    v, x0, y0, cw, ch = ref._setup(scene, screen, W, H, cell)
    zbuf = ref._resolve(scene, v, x0, y0, cw, ch, W, H, torch.float32,
                        1 << 23)
    winners = zbuf[zbuf != ref.NO_HIT] & ref.TRI_MASK
    return int((scene.face_image[winners] >= 0).sum())


def direct_longest(meta, ntx, nty):
    """The most alive triangles whose tile rect holds one tile, counted
    tile by tile from the meta rows [x0, y0, rx, c]."""
    x0, y0, rx, c = (meta[i].long() for i in range(4))
    alive = c > 0
    x1 = x0 + torch.where(alive, rx, 0)
    y1 = y0 + torch.where(alive, c // torch.clamp(rx, min=1), 0)
    jy, jx = torch.meshgrid(torch.arange(nty), torch.arange(ntx),
                            indexing="ij")
    jx, jy = jx.reshape(-1, 1), jy.reshape(-1, 1)
    hold = alive & (x0 <= jx) & (jx < x1) & (y0 <= jy) & (jy < y1)
    return int(hold.sum(dim=1).max())


@pytest.mark.parametrize("seed", [2_400_000_131, 3_100_000_007])
def test_tile_path_equals_the_reference_and_reports_its_longest_list(
        monkeypatch, seed):
    from torch.profiler import ProfilerActivity, profile

    from compute_renderer_torch import tracing
    from compute_renderer_torch.backends import binning
    from compute_renderer_torch.engine.renderer import Renderer

    cfg = small_config()
    arrays = harness.build_scene(cfg)
    try:
        program = harness.Program(cfg, arrays, torch.device("cpu"))
    finally:
        arrays.remove_files()
    renderer = Renderer(program.scene.mesh, W, H, device="cpu", **TILE,
                        **program.scene.renderer_options())
    assert renderer.mode == "texf_mip"
    mix = fb_small.traffic("batch")
    dt = float(mix["dt"])
    path = cam.LookAround(mix["camera"], cfg["camera"], dt, seed)
    rng = np.random.default_rng([seed, 3])
    ids = sorted(rng.choice(path.period, 3, replace=False).tolist())
    uniforms = [program.look(*path.offsets[i], dt) for i in ids]
    renderer.render_batch_device(uniforms)  # the capacities settle
    fn, grids = binning.bin_tiles_meta, []

    def recorded(meta, ntx, nty, *args, **kwargs):
        grids.append((meta.clone(), ntx, nty))
        bins = fn(meta, ntx, nty, *args, **kwargs)
        grids[-1] += (bins["layout"],)
        return bins

    monkeypatch.setattr(binning, "bin_tiles_meta", recorded)
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        frames = renderer.render_batch_device(uniforms, check=False)
    counts, peaks = tracing.frame_counts(), tracing.frame_peaks()
    tracing.reset()
    assert not renderer.flush_overflow()
    assert len(grids) == 3 and {g[3] for g in grids} == {"flat"}
    assert peaks == {"list": max(direct_longest(*g[:3]) for g in grids)}
    assert peaks["list"] > 0
    scene = harness.reference_scene(cfg, arrays, "cpu")
    limit = harness.load_json("limits", CELL)["bad_px"]
    textured = 0
    for frame, i in zip(frames, ids):
        vpos, vp = path.pose(i).matrices(W / H)
        expect = ref.render(scene, vpos, vp, cfg["lights"], W, H,
                            cell=cfg["cell"], tex_filter="anisotropic")
        assert harness.bad_pixels(frame, expect) <= min(limit, SMALL_BAD_PX)
        textured += reference_textured(scene, vpos, vp, cfg["cell"])
    assert counts["frames"] == 3
    assert counts["textured"] == textured
    assert 0 < textured < 3 * W * H
    program.close()


# --------------------------------------------------------------------------
# The reader, on a synthetic trace
# --------------------------------------------------------------------------

WINDOW = "frame_bench.window"
KERNELS = {  # name: (start, duration) in microseconds
    "void (anonymous namespace)::raster_kernel<4>(float const*)": (10, 60),
    "void (anonymous namespace)::texture_tail_mip_kernel<3>(float const*)":
        (70, 40),
}


def synthetic(device=True):
    events = [{"ph": "X", "name": WINDOW, "cat": "user_annotation",
               "ts": 0.0, "dur": 1000.0}]
    if device:
        events += [{"ph": "X", "name": name, "cat": "kernel", "ts": ts,
                    "dur": dur} for name, (ts, dur) in KERNELS.items()]
    return {"traceEvents": events}


def ctx(frames=2, device=True, traced=True):
    cfg = harness.load_json("configs", CONFIG)
    if not traced:
        return harness.Context(cfg, {"frames": 0}, 1.0)
    return harness.Context(cfg, {"frames": 0}, 1.0,
                           trace.Trace(synthetic(device), WINDOW),
                           {"frames": frames})


@pytest.fixture
def tracing():
    from compute_renderer_torch import tracing

    tracing.reset()
    yield tracing
    tracing.reset()


def peaked(tracing, *lists):
    for n in lists:
        tracing.add_frames(torch.tensor([20_000, 190, 300_000],
                                        dtype=torch.int64), 64,
                           peaks=torch.tensor([n], dtype=torch.int64))


def test_longest_list_reads_the_peak(tracing):
    peaked(tracing, 3_140, 2_900)
    assert harness.read_metric(METRIC, ctx()) == 3_140
    # The counts read as before beside it.
    assert harness.read_metric("raster.tiles_per_frame", ctx()) == 190 / 64


def test_longest_list_none_without_a_trace_or_device(tracing):
    peaked(tracing, 3_140)
    assert harness.read_metric(METRIC, ctx(traced=False)) is None
    assert harness.read_metric(METRIC, ctx(device=False)) is None
    assert harness.read_metric(METRIC, ctx(frames=0)) is None


def test_longest_list_none_without_the_reading(tracing, monkeypatch):
    # Batches that added no peak: nothing to read.
    tracing.add_frames(torch.tensor([20_000, 190, 300_000],
                                    dtype=torch.int64), 64)
    assert harness.read_metric(METRIC, ctx()) is None
    # A program whose tracing has no peaks (the parent of the reading).
    monkeypatch.delattr(tracing, "frame_peaks")
    assert harness.read_metric(METRIC, ctx()) is None


def test_longest_list_none_from_a_program_without_tracing(monkeypatch):
    import compute_renderer_torch

    monkeypatch.delattr(compute_renderer_torch, "tracing")
    monkeypatch.setitem(sys.modules, "compute_renderer_torch.tracing", None)
    assert harness.read_metric(METRIC, ctx()) is None
