"""The textured million-triangle configuration under trilinear filtering
(``configs/structured_trilinear.json``), its cell, the texture layer and
its metrics, on the CPU:

- the configuration as its file states it, and its entries in
  ``BENCHMARK.json``;
- a small version of its own part (the structured scene at terrain_n 120
  with a 256-texel ground, so that the 96x72 frames minify and the lods
  leave level 0) through the harness reads ``correct``, and reads not
  correct with the program's filter forced to ``bilinear`` or with the
  bfloat16 control in its place;
- the port's renderer on the micro path at that size equals the
  reference within the cell's limit, and its count of textured pixels
  (``tracing.frame_counts()["textured"]``) equals the reference's count
  of covered pixels whose winner has an image;
- each new reader on a synthetic trace gives its value, and None without
  a trace, without the program's counter or at a configuration without
  the mode it reads;
- the texture layer's kernel names are no substrings of another layer's."""

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

CONFIG = "structured_trilinear"
CELL = "structured_trilinear.batch"
W, H = fb_small.WIDTH, fb_small.HEIGHT
# The small run's limit, as test_fb_textures.py's: between the program's
# reading (0 at this size) and the faults' and the control's.
SMALL_BAD_PX = 100
NEW_METRICS = ("texture.ms_per_frame", "texture.pixels_per_frame",
               "front_mip_roofline", "mip_rows_roofline",
               "texture_tail_roofline")
JOINED = ("frame_ms", "device.idle_pct", "device.kernels_per_frame",
          "host.calls_per_frame", "front.ms_per_frame",
          "binning.ms_per_frame", "raster.ms_per_frame",
          "binning.pairs_per_frame", "raster.tiles_per_frame",
          "bin_sort_roofline", "host.pack_ms", "host.upload_ms",
          "host.replay_ms")


def small_config():
    """The configuration at 96x72 with its part cut to the 36k build's
    geometry, a 256-texel ground and a 64-texel marble image."""
    cfg = copy.deepcopy(harness.load_json("configs", CONFIG))
    cfg["width"], cfg["height"] = W, H
    cfg["geometry"][0].update(terrain_n=120, statue_nu=80, statue_nv=44,
                              ruins=40, ground_px=256, marble_px=64)
    cfg["triangles"] = None
    return cfg


def short_mix(mix):
    mix.update(batch=4)
    mix["camera"]["period_s"] = 0.25


def run_small(**kwargs):
    return fb_small.run(CELL, cfg=small_config(), traffic_changes=short_mix,
                        bad_px=SMALL_BAD_PX, **kwargs)


# --------------------------------------------------------------------------
# The configuration and its entries
# --------------------------------------------------------------------------

def test_configuration_file():
    cfg = harness.load_json("configs", CONFIG)
    assert (cfg["shading"], cfg["tex_filter"]) == ("textures", "trilinear")
    assert (cfg["width"], cfg["height"], cfg["cell"]) == (1024, 768, 8)
    assert cfg["lights"] == harness.load_json("configs", "san_miguel")[
        "lights"]
    assert cfg["camera"] == {"spawn": [13.566635, 4.0, 24.0],
                             "interactive": "walk"}
    assert cfg["geometry"] == [{
        "kind": objscene.KIND, "terrain_n": 600, "statue_nu": 530,
        "statue_nv": 284, "ruins": 200, "size": 60.0, "mtl": "structured",
        "ground_px": 4096, "marble_px": 1024}]
    assert cfg["reduced"] == [] and len(cfg["assumed"]) >= 3
    # The generator's faces: quads of the terrain and the statue's rows
    # as two triangles each, 12 a ruin, the banner's quad.
    p = cfg["geometry"][0]
    assert (2 * p["terrain_n"] ** 2 + 2 * p["statue_nu"] * p["statue_nv"]
            + 12 * p["ruins"] + 2) == cfg["triangles"] == 1023442


def test_benchmark_entries():
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
        assert listed[name]["workloads"][-1] == CELL, name
    # Not in front_roofline's (its bytes are keyed by mode, not by
    # shading), nor in raster.samples_per_frame's, which
    # test_fb_samples_metric.py holds to san_miguel.batch alone.
    assert CELL not in listed["front_roofline"]["workloads"]
    assert CELL not in listed["raster.samples_per_frame"]["workloads"]
    for name in NEW_METRICS:
        m = listed[name]
        assert (m["source"], m["moves"], m["workloads"]) == (
            "device_trace", "frame_ms", [CELL]), name
        assert m["layer"] == ("front" if name == "front_mip_roofline"
                              else "texture")
    assert [m["name"] for m in bench["per_layer"][-5:]] == list(NEW_METRICS)
    assert isinstance(harness.load_json("limits", CELL)["bad_px"], int)


def test_texture_layer_names_no_other_layers_kernel():
    texture = harness.load_json("layers", "texture")["kernels"]
    assert texture == ["mip_rows_kernel", "texture_tail_mip_kernel",
                       "texture_tail_kernel", "deferred_tail_kernel",
                       "vertex_stage_kernel"]
    for layer in ("front", "binning", "raster", "bin_sort"):
        for other in harness.load_json("layers", layer)["kernels"]:
            for name in texture:
                assert name not in other and other not in name, (name, other)


# --------------------------------------------------------------------------
# The small run, its faults and the control
# --------------------------------------------------------------------------

def test_small_run_is_correct():
    result, numbers = run_small()
    assert result["correct"] is True, numbers
    assert numbers["bad_px"][0] == 0
    assert result["attempted"] > 0


def bilinear_filter(monkeypatch):
    from compute_renderer_torch.engine.scene import Scene

    orig = Scene.renderer_options

    def broken(self):
        return dict(orig(self), tex_filter="bilinear")

    monkeypatch.setattr(Scene, "renderer_options", broken)


def control_in_place(monkeypatch):
    from compute_renderer_torch.engine.renderer import Renderer

    orig = Renderer.render_batch_device
    cfg = small_config()

    def control(self, seq, *args, **kwargs):
        out = orig(self, seq, *args, **kwargs)
        arrays = harness.build_scene(cfg)
        arrays.remove_files()
        scene = harness.reference_scene(cfg, arrays, "cpu")
        for k, u in enumerate(seq):
            out[k] = ref.render(scene, u.view_position, u.view_proj,
                                cfg["lights"], self.width, self.height,
                                dtype=torch.bfloat16,
                                tex_filter=cfg["tex_filter"])
        return out

    monkeypatch.setattr(Renderer, "render_batch_device", control)


@pytest.mark.parametrize("fault", [bilinear_filter, control_in_place])
def test_small_fault_is_not_correct(monkeypatch, fault):
    fault(monkeypatch)
    result, numbers = run_small()
    assert result["correct"] is False, numbers
    assert numbers["bad_px"][0] > numbers["bad_px"][1]


# --------------------------------------------------------------------------
# The micro path against the reference: frames and textured pixels
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


def test_micro_path_equals_the_reference_and_counts_its_texels():
    from torch.profiler import ProfilerActivity, profile

    from compute_renderer_torch import tracing
    from compute_renderer_torch.engine.renderer import Renderer

    cfg = small_config()
    arrays = harness.build_scene(cfg)
    try:
        program = harness.Program(cfg, arrays, torch.device("cpu"))
    finally:
        arrays.remove_files()
    renderer = Renderer(program.scene.mesh, W, H, device="cpu",
                        path="micro", **program.scene.renderer_options())
    assert renderer.mode == "texf_mip"
    mix = fb_small.traffic("batch")
    dt = float(mix["dt"])
    path = cam.LookAround(mix["camera"], cfg["camera"], dt, 2_400_000_117)
    ids = [0, path.period // 3, 2 * path.period // 3]
    uniforms = [program.look(*path.offsets[i], dt) for i in ids]
    renderer.render_batch_device(uniforms)  # the pair capacity settles
    tracing.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        frames = renderer.render_batch_device(uniforms, check=False)
    counts = tracing.frame_counts()
    tracing.reset()
    assert not renderer.flush_overflow()
    scene = harness.reference_scene(cfg, arrays, "cpu")
    limit = harness.load_json("limits", CELL)["bad_px"]
    textured = 0
    for frame, i in zip(frames, ids):
        vpos, vp = path.pose(i).matrices(W / H)
        expect = ref.render(scene, vpos, vp, cfg["lights"], W, H,
                            cell=cfg["cell"], tex_filter="trilinear")
        assert harness.bad_pixels(frame, expect) <= min(limit, SMALL_BAD_PX)
        textured += reference_textured(scene, vpos, vp, cfg["cell"])
    assert counts["frames"] == 3
    assert counts["textured"] == textured
    assert 0 < textured < 3 * W * H
    program.close()


# --------------------------------------------------------------------------
# The readers, on a synthetic trace
# --------------------------------------------------------------------------

WINDOW = "frame_bench.window"
KERNELS = {  # name: (start, duration) in microseconds
    "void (anonymous namespace)::front_kernel<4>(float const*)": (10, 50),
    "void (anonymous namespace)::mip_rows_kernel<2>(float const*)": (0, 10),
    "void (anonymous namespace)::texture_tail_mip_kernel<2>(float const*)":
        (70, 8),
    "(anonymous namespace)::micro_kernel(Frame)": (60, 5),
}


def synthetic(device=True):
    events = [{"ph": "X", "name": WINDOW, "cat": "user_annotation",
               "ts": 0.0, "dur": 1000.0}]
    if device:
        events += [{"ph": "X", "name": name, "cat": "kernel", "ts": ts,
                    "dur": dur} for name, (ts, dur) in KERNELS.items()]
    return {"traceEvents": events}


def ctx(frames=2, device=True, traced=True, **config):
    cfg = dict(harness.load_json("configs", CONFIG), triangles=1_000_000)
    cfg.update(config)
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


def counted(tracing, textured=300_000):
    tracing.add_frames(torch.tensor([600_000, 300, 4_000_000, textured],
                                    dtype=torch.int64), 2)


def test_texture_layer_time(tracing):
    assert harness.read_metric("texture.ms_per_frame", ctx()) == \
        pytest.approx((10 + 8) / 2 / 1e3)


def test_textured_pixels_a_frame(tracing):
    counted(tracing)
    assert harness.read_metric("texture.pixels_per_frame", ctx()) == 150_000
    # The pairs are read as before beside it.
    assert harness.read_metric("binning.pairs_per_frame", ctx()) == 300_000


def test_front_mip_roofline(tracing):
    # 328 B a triangle over 3.35 TB/s, against 25 us a frame.
    want = 100.0 * (1_000_000 * 328 / 3.35e12) / 25e-6
    assert harness.read_metric("front_mip_roofline", ctx()) == \
        pytest.approx(want)
    assert 72 + 56 + 46 * 4 + 16 == 328


def test_mip_rows_roofline(tracing):
    want = 100.0 * (1_000_000 * 46 / 3.35e12) / 5e-6
    assert harness.read_metric("mip_rows_roofline", ctx()) == \
        pytest.approx(want)
    # The frozen 46 B: 36 a triangle and 20 a vertex at the structured
    # scene's vertices (objgen v2) for its triangles.
    vertices = 601 ** 2 + 531 * 285 + 8 * 200 + 4
    assert int(36 + 20 * vertices / 1023442) == 46


def test_texture_tail_roofline(tracing):
    counted(tracing, textured=300_000)
    # Each pixel's key and RGBA, each textured pixel's 14 planes (two
    # lights), over 3.35 TB/s against 4 us a frame.
    nbytes = 1024 * 768 * 8 + 150_000 * 14 * 4
    want = 100.0 * (nbytes / 3.35e12) / 4e-6
    assert harness.read_metric("texture_tail_roofline", ctx()) == \
        pytest.approx(want)


def test_none_without_a_trace_or_device(tracing):
    counted(tracing)
    for name in NEW_METRICS:
        assert harness.read_metric(name, ctx(traced=False)) is None, name
        assert harness.read_metric(name, ctx(device=False)) is None, name


def test_none_without_the_counter(tracing, monkeypatch):
    from frame_bench import program

    # Counts of a program whose accumulator has no textured word.
    tracing.add_frames(torch.tensor([600_000, 300, 4_000_000],
                                    dtype=torch.int64), 2)
    for name in ("texture.pixels_per_frame", "texture_tail_roofline"):
        assert harness.read_metric(name, ctx()) is None
    # The parent of the change that added the counter.
    monkeypatch.setattr(program, "frame_counts", lambda c: {
        "frames": 4, "pairs": 1_000, "tiles": 40, "samples": 9_000})
    for name in ("texture.pixels_per_frame", "texture_tail_roofline"):
        assert harness.read_metric(name, ctx()) is None
    # The times need no counter.
    assert harness.read_metric("texture.ms_per_frame", ctx()) is not None


def test_none_from_a_program_without_tracing(monkeypatch):
    import compute_renderer_torch

    monkeypatch.delattr(compute_renderer_torch, "tracing")
    monkeypatch.setitem(sys.modules, "compute_renderer_torch.tracing", None)
    for name in ("texture.pixels_per_frame", "texture_tail_roofline"):
        assert harness.read_metric(name, ctx()) is None


@pytest.mark.parametrize("config", [{"shading": "base"},
                                    {"tex_filter": "bilinear"}])
def test_mode_rooflines_none_outside_texf_mip(tracing, config):
    for name in ("front_mip_roofline", "mip_rows_roofline"):
        assert harness.read_metric(name, ctx(**config)) is None


def test_base_cells_counts_read_as_before(tracing):
    # A base-shaded batch adds three words: no textured key, and the new
    # readers find nothing in its counts.
    tracing.add_frames(torch.tensor([600_000, 300, 4_000_000],
                                    dtype=torch.int64), 2)
    assert set(tracing.frame_counts()) == {"frames", "pairs", "tiles",
                                           "samples"}
    assert np.isclose(harness.read_metric("raster.samples_per_frame", ctx()),
                      2_000_000)
