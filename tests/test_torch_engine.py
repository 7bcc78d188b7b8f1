"""The port's engine (``engine/renderer.py``): batches, the tile-shape
tuner, ``effect_kind``, ``resize``, the graph cache, ``bench_torch.py``
and ``bench/profiling.py``.

On the CPU the renderer runs the twins eagerly; on the card each frame
replays a captured CUDA graph (the ``cuda``-marked tests at the end).
Tolerances: against the JAX engine, the pixel contract of
``tests/test_torch_slice.py`` (at most max(2, H*W/500) pixels more than
2 LSB off: XLA:CPU contracts mul+add into FMA on exact edges); within the
port (batch against single frames, one tile shape against another, graph
against eager, a resized renderer against a fresh one) bitwise."""

import types

import numpy as np
import pytest

from tests.torch_parity import (  # noqa: F401 (fixtures)
    assert_frames_match, cuda_device, port, tpu,
)

W, H = 128, 96
DT = 1.0 / 60.0


def _scenes(pkgs, model="suzanne.obj", effect=None):
    """bench.py's model under an orbit camera (so frames animate), in each
    package of ``pkgs``."""
    out = []
    for pkg in pkgs:
        eff = effect(pkg) if effect else None
        cfg = pkg.scene.SceneConfig(
            model_path=model, effect=eff,
            camera_config=pkg.scene.CameraConfig(distance=3.0))
        out.append(pkg.scene.Scene.from_config(cfg, W, H))
    return out


def _advance(scene, n):
    """n animated frames' uniforms: the orbit camera and the effect move."""
    out = []
    for _ in range(n):
        scene.get_active_camera().update_over_time(0.2)
        out.append(scene.update(DT))
    return out


EFFECTS = {
    None: None,
    "wave": lambda p: p.effects.Effect.wave(0.3, 4.0, 2.0,
                                            p.effects.WaveDirection.RADIAL),
    "edge_melt": lambda p: p.effects.Effect.edge_melt(0.2, 1.5),
    "voxelize": lambda p: p.effects.Effect.voxelize(0.3, 1.5),
    "mirage": lambda p: p.effects.Effect.mirage(0.6, 0.7, 0.3),
}


@pytest.mark.parametrize("path", ["tile", "micro"])
def test_batch_matches_jax_engine(port, tpu, path):
    # render_batch_device against the JAX engine's scanned batch on the
    # same uniforms: Suzanne, four animated frames, on either path.
    js, ts = _scenes((tpu, port))
    jr = tpu.renderer.Renderer(js.mesh, W, H, backend="tpu", path=path,
                               **js.renderer_options())
    tr = port.renderer.Renderer(ts.mesh, W, H, device="cpu", path=path,
                                **ts.renderer_options())
    a = np.asarray(jr.render_batch_device(_advance(js, 4)))
    b = tr.render_batch_device(_advance(ts, 4)).numpy()
    assert b.shape == (4, H, W, 4) and b.dtype == np.uint8
    for i in range(4):
        assert_frames_match(a[i], b[i])
    assert not (b[0] == b[3]).all()  # the frames animate


@pytest.mark.parametrize("path", ["tile", "micro"])
def test_batch_equals_single_frames(port, path):
    (ts,) = _scenes((port,))
    r = port.renderer.Renderer(ts.mesh, W, H, device="cpu", path=path)
    us = _advance(ts, 3)
    batch = r.render_batch_device(us)
    for i, u in enumerate(us):
        rgba, key, overflow = r.render_device(u)
        assert port.torch.equal(batch[i], rgba)
        assert not overflow.any()


@pytest.mark.parametrize("effect", [None, "wave", "edge_melt"])
def test_tile_shapes_give_one_image(port, tpu, effect):
    # The tuner's premise (JAX engine/renderer.py:318-324): plain, wave and
    # edge-melt frames are the same image at every candidate tile shape.
    js, ts = _scenes((tpu, port), effect=EFFECTS[effect])
    us_t, us_j = _advance(ts, 2), _advance(js, 2)
    frames = {}
    for shape in port.cuda.TILE_CANDIDATES:
        r = port.renderer.Renderer(ts.mesh, W, H, device="cpu", path="tile",
                                   tile_h=shape[0], tile_w=shape[1])
        frames[shape] = r.render_batch_device(us_t).numpy()
    a, b = frames.values()
    np.testing.assert_array_equal(a, b)
    jr = tpu.renderer.Renderer(js.mesh, W, H, backend="tpu", path="tile",
                               tile_h=8, tile_w=128)
    for i, u in enumerate(us_j):
        assert_frames_match(jr.render(u), frames[(8, 128)][i])


def test_tile_candidates_match_jax(port, tpu):
    assert port.cuda.TILE_CANDIDATES == tpu.backend.TILE_CANDIDATES
    assert port.cuda.choose_tile(1280, 1024, 768) == (16, 256)


@pytest.mark.parametrize("effect", [None, "wave", "edge_melt"])
def test_tuner_admits_static_coverage_effects(port, effect):
    (ts,) = _scenes((port,), effect=EFFECTS[effect])
    r = port.renderer.Renderer(ts.mesh, W, H, device="cpu",
                               **ts.renderer_options())
    assert r._tile_tunable() and not r._tile_tuned
    # ...but times nothing on the CPU: the first frame only disarms it.
    r.render(ts.update(DT))
    assert r._tile_tuned and not r.tile_timings
    assert "tile_h" not in r.options and "tile_w" not in r.options


@pytest.mark.parametrize("case", ["pinned", "autotune_off", "voxelize",
                                  "mirage", "dynamic", "micro"])
def test_tuner_is_a_no_op(port, case):
    effect = EFFECTS[case] if case in ("voxelize", "mirage") else None
    (ts,) = _scenes((port,), effect=effect)
    opts = ts.renderer_options()
    if case == "pinned":
        opts.update(tile_h=16, tile_w=256)
    elif case == "autotune_off":
        opts["tile_autotune"] = False
    elif case == "dynamic":
        opts.pop("effect_kind")
    elif case == "micro":
        opts["path"] = "micro"
    r = port.renderer.Renderer(ts.mesh, W, H, device="cpu", **opts)
    if case in ("pinned", "autotune_off"):
        assert r._tile_tuned  # disarmed from the start
    else:
        assert not r._tile_tunable()
    before = dict(r.options)
    r._maybe_tune_tile(_advance(ts, 2))
    assert r.options == before and not r.tile_timings


@pytest.mark.parametrize("frames", [1, 2])
def test_tune_tile_times_each_candidate(port, frames):
    # The tuner's timing loop, run directly (the renderer runs it on the
    # card only): each candidate is timed on the caller's granularity,
    # the winner is kept, and the image does not change.
    (ts,) = _scenes((port,))
    us = _advance(ts, frames)
    r = port.renderer.Renderer(ts.mesh, W, H, device="cpu",
                               **ts.renderer_options())
    ref = r.render_batch_device(us).numpy()
    r._tune_tile(us)
    assert set(r.tile_timings) == set(port.cuda.TILE_CANDIDATES)
    shape = (r.options["tile_h"], r.options["tile_w"])
    assert r.tile_timings[shape] == min(r.tile_timings.values())
    np.testing.assert_array_equal(r.render_batch_device(us).numpy(), ref)


@pytest.mark.parametrize("effect", list(EFFECTS))
def test_effect_kind_option(port, tpu, effect):
    # Scene.renderer_options gives the static effect class as the JAX
    # scene does, and the renderer takes it.
    js, ts = _scenes((tpu, port), effect=EFFECTS[effect])
    opts = ts.renderer_options()
    assert opts == js.renderer_options()
    kind = 0 if effect is None else ts.effect.kind
    assert opts["effect_kind"] == kind
    r = port.renderer.Renderer(ts.mesh, W, H, device="cpu", **opts)
    assert r.effect_kind == kind and "effect_kind" not in r.options


@pytest.mark.parametrize("option", ["micro_unroll", "worklist", "bogus"])
def test_unknown_options_raise(port, option):
    mesh = port.procedural.make_model("suzanne.obj")
    with pytest.raises(NotImplementedError, match=option):
        port.renderer.Renderer(mesh, W, H, device="cpu", **{option: 1})


def test_graph_key(port):
    (ts,) = _scenes((port,))
    r = port.renderer.Renderer(ts.mesh, W, H, device="cpu")
    key = r.graph_key(2)
    assert key == (2, W, H, "tile", "base", ())
    assert r.graph_key(1) != key  # the light count
    r.options.update(tile_h=8, tile_w=128)
    assert r.graph_key(2) == (2, W, H, "tile", "base",
                              (("tile_h", 8), ("tile_w", 128)))
    r.options["pair_cap"] = 4096
    assert ("pair_cap", 4096) in r.graph_key(2)[5]
    r.options["path"] = "micro"
    assert r.graph_key(2)[3] == "micro"
    r2 = port.renderer.Renderer(ts.mesh, W, H, device="cpu", ssaa=2)
    assert r2.graph_key(2)[1:3] == (2 * W, 2 * H)


class _FakeGraph:
    def __init__(self):
        self.was_reset = False

    def reset(self):
        self.was_reset = True


def _stacked_triangles(port, n=200):
    """n coincident triangles at distinct depths: one tile's list of n."""
    base = port.procedural.single_triangle(z=0.0)
    pos = np.tile(base.positions, (n, 1))
    pos[:, 2] += np.repeat(np.linspace(0, 0.5, n), 3)
    return port.convert.mesh_from_arrays(
        pos, np.tile(base.normals, (n, 1)), np.tile(base.uvs, (n, 1)),
        np.arange(3 * n, dtype=np.uint32))


def _facing_uniforms(port):
    """A first-person camera at (0, 0, 3) facing the stacked triangles,
    one light."""
    cam = port.camera.Camera.first_person([0, 0, 3.0], aspect=W / H)
    u = cam.uniform()
    return port.convert.uniforms_from_arrays(
        u.view_position, u.view_proj, [[0.0, 0.0, 5.0]], [[1.0, 0.9, 0.8]],
        [1.0], [0, 0, 0, 0, 0, 0])


@pytest.mark.parametrize("event", ["calibrate", "overflow_retry",
                                   "tile_to_micro", "resize", "tune"])
def test_events_drop_the_graph_cache(port, event):
    # Each event that changes what a frame's graph holds drops the cached
    # graphs and frees them (the JAX engine clears its step cache); the
    # tuner keeps only the winner's.
    (ts,) = _scenes((port,))
    mesh = _stacked_triangles(port) if event == "overflow_retry" \
        else ts.mesh
    opts = {"path": "micro"} if event == "calibrate" else {}
    if event == "overflow_retry":
        opts["tile_cap"] = 96
    r = port.renderer.Renderer(mesh, W, H, device="cpu", **opts)
    u = _facing_uniforms(port) if event == "overflow_retry" \
        else ts.update(DT)
    fakes = {("stale", i): types.SimpleNamespace(graph=_FakeGraph())
             for i in range(2)}
    r._graphs.update(fakes)
    if event == "calibrate":
        r._maybe_calibrate(u)
        assert "pair_cap" in r.options
    elif event == "overflow_retry":
        r.render(u)
        assert r.options["tile_cap"] >= 200
    elif event == "tile_to_micro":
        r._grow_caps(tile_needed=port.cuda.MAX_TILE_CAP + 1)
        assert r.options["path"] == "micro" and r._calibrate_pair_cap
    elif event == "resize":
        r.resize(2 * W, 2 * H)
    else:
        us = _advance(ts, 2)
        r.options.update(tile_h=8, tile_w=128)
        kept = types.SimpleNamespace(graph=_FakeGraph())
        r._graphs[r.graph_key(2)] = kept
        r.options.pop("tile_h"), r.options.pop("tile_w")
        r._tune_tile(us)
        winner = r.graph_key(2)
        assert list(r._graphs) == ([winner] if winner in r._graphs else [])
        assert kept.graph.was_reset == (winner[5] != (("tile_h", 8),
                                                      ("tile_w", 128)))
    assert not any(k in r._graphs for k in fakes)
    assert all(f.graph.was_reset for f in fakes.values())


@pytest.mark.parametrize("path", ["tile", "micro"])
def test_resize_matches_fresh_renderer(port, path):
    (ts,) = _scenes((port,))
    us = _advance(ts, 2)
    r = port.renderer.Renderer(ts.mesh, W, H, device="cpu", path=path,
                               **ts.renderer_options())
    r.render(us[0])
    r.options.update(tile_h=8, tile_w=128)  # as a tuned renderer holds
    r.resize(96, 64)
    assert (r.width, r.height) == (96, 64)
    assert "tile_h" not in r.options and not r._tile_tuned
    assert "pair_cap" not in r.options and r._calibrate_pair_cap
    fresh = port.renderer.Renderer(ts.mesh, 96, 64, device="cpu", path=path,
                                   **ts.renderer_options())
    for u in us:
        np.testing.assert_array_equal(r.render(u), fresh.render(u))
    # A pinned tile shape stays pinned across a resize.
    pinned = port.renderer.Renderer(ts.mesh, W, H, device="cpu", tile_h=8,
                                    tile_w=128)
    pinned.resize(96, 64)
    assert (pinned.options["tile_h"], pinned.options["tile_w"]) == (8, 128)


class _FakeBenchRenderer:
    """A renderer whose batches take ``cost(n)`` seconds of a fake clock."""

    def __init__(self, cost):
        self.cost = cost
        self.now = 0.0
        self.calls = []

    def clock(self):
        return self.now

    def render_batch_device(self, batch, check=True):
        self.calls.append((len(batch), check))
        self.now += self.cost(len(batch))

    def fence_pending(self):
        pass

    def flush_overflow(self):
        return False


def test_bench_torch_slope_and_guard():
    import bench_torch

    # 0.2 ms a frame plus 3 ms a batch: the slope recovers 0.2.
    r = _FakeBenchRenderer(lambda n: 3e-3 + 2e-4 * n)
    small, large = bench_torch.time_batches(r, lambda n: [None] * n, 64,
                                            256, 4, clock=r.clock)
    assert r.calls[:2] == [(64, True), (256, True)]  # checked warm-ups
    assert r.calls[2:] == [(64, False)] * 4 + [(256, False)] * 4
    res = bench_torch.slope_result(small, large, 64, 256)
    assert res["slope_valid"]
    assert res["slope_ms"] == pytest.approx(0.2)
    assert res["wall_ms_large"] == pytest.approx((3 + 0.2 * 256) / 256)
    assert res["ms_per_frame"] == pytest.approx(0.2)
    # A slope above the wall number is capped at it.
    res = bench_torch.slope_result(0.0, 0.3, 64, 256)
    assert res["ms_per_frame"] == pytest.approx(res["wall_ms_large"])
    # A non-positive slope is no measurement: the wall number stands.
    res = bench_torch.slope_result(0.05, 0.04, 64, 256)
    assert not res["slope_valid"]
    assert res["ms_per_frame"] == pytest.approx(0.04 / 256 * 1e3)


def test_bench_torch_needs_a_card(port, monkeypatch, capsys):
    import bench_torch

    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)
    assert bench_torch.main() == 1
    out = capsys.readouterr()
    assert out.out == "" and "NVIDIA GPU" in out.err


def test_profiling_needs_a_card(port):
    from compute_renderer_torch.bench import profiling

    (ts,) = _scenes((port,))
    u = ts.update(DT)
    for fn in (profiling.stage_timings, profiling.stage_timings_micro):
        with pytest.raises(RuntimeError, match="CUDA card"):
            fn(ts.mesh, u, W, H, device="cpu")
    r = port.renderer.Renderer(ts.mesh, W, H, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA card"):
        profiling.profile_batch(r, [u], {})
    with pytest.raises(RuntimeError, match="CUDA card"):
        profiling.host_calls_per_frame(r, lambda n: [u] * n)


def test_profiling_trace_writes_a_chrome_trace(port, tmp_path):
    from compute_renderer_torch.bench import profiling

    (ts,) = _scenes((port,))
    r = port.renderer.Renderer(ts.mesh, W, H, device="cpu")
    with profiling.trace(str(tmp_path)):
        r.render(ts.update(DT))
    traces = list(tmp_path.glob("*.pt.trace.json"))
    assert len(traces) == 1 and traces[0].stat().st_size > 0


# ---------------------------------------------------------------------------
# On the card: every frame a replayed CUDA graph
# ---------------------------------------------------------------------------

def _mode_mesh(port, mode):
    """Suzanne with what ``mode`` reads: kd rows (mat), a 16x8 texture
    over every face (the texture modes)."""
    mesh = port.procedural.make_model("suzanne.obj")
    if mode == "base":
        return mesh, {}
    rng = np.random.default_rng(7)
    T = mesh.num_triangles
    kd = rng.uniform(0.2, 1.0, (T, 3))
    if mode == "mat":
        return port.convert.mesh_from_arrays(
            mesh.positions, mesh.normals, mesh.uvs, mesh.indices,
            face_kd=kd), {}
    textured = port.convert.mesh_from_arrays(
        mesh.positions, mesh.normals, mesh.uvs, mesh.indices, face_kd=kd,
        face_tex=np.where(np.arange(T) % 5 == 0, -1, 0),
        texels=rng.uniform(0, 1, (16 * 8, 3)), tex_table=[[0, 16, 8]])
    return textured, {"texf": {}, "texf_mip": {"tex_filter": "trilinear"},
                      "vis": {"tex_mode": "deferred"}}[mode]


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tile", "micro"])
@pytest.mark.parametrize("mode", ["base", "mat", "texf", "texf_mip",
                                  "vis"])
def test_graph_frames_equal_eager_on_card(port, cuda_device, path, mode):
    mesh, opts = _mode_mesh(port, mode)
    (ts,) = _scenes((port,))
    r = port.renderer.Renderer(mesh, W, H, device=cuda_device, path=path,
                               **opts)
    assert r.mode == mode
    us = _advance(ts, 3)
    graph = r.render_batch_device(us)
    assert len(r._graphs) == 1
    eager = r.render_batch_device(us, eager=True)
    assert port.torch.equal(graph, eager)
    for i, u in enumerate(us):
        assert port.torch.equal(r.render_device(u)[0], graph[i])


@pytest.mark.cuda
def test_earlier_frame_unchanged_after_replay_on_card(port, cuda_device):
    (ts,) = _scenes((port,))
    r = port.renderer.Renderer(ts.mesh, W, H, device=cuda_device)
    u1, u2 = _advance(ts, 2)
    rgba1, key1, _ = r.render_device(u1)
    kept = (rgba1.clone(), key1.clone())
    rgba2, key2, _ = r.render_device(u2)
    port.torch.cuda.synchronize()
    assert port.torch.equal(rgba1, kept[0]) and port.torch.equal(key1,
                                                                kept[1])
    assert not port.torch.equal(rgba1, rgba2)
    batch = r.render_batch_device([u1])
    r.render_batch_device([u2])
    assert port.torch.equal(batch[0], kept[0])


@pytest.mark.cuda
def test_overflow_retry_recaptures_on_card(port, cuda_device):
    mesh = _stacked_triangles(port)
    u = _facing_uniforms(port)
    r = port.renderer.Renderer(mesh, W, H, device=cuda_device, tile_cap=96)
    img = r.render(u)
    assert r.options["tile_cap"] >= 200
    # Only the graph at the grown capacity is left.
    assert list(r._graphs) == [r.graph_key(1)]
    eager = r.render_batch_device([u], eager=True)[0].cpu().numpy()
    np.testing.assert_array_equal(img, eager)
    assert (img[..., 0] > 0).any()


@pytest.mark.cuda
def test_merge_scratch_made_before_capture_stays_clear_on_card(
        port, cuda_device):
    (ts,) = _scenes((port,))
    r = port.renderer.Renderer(ts.mesh, W, H, device=cuda_device,
                               path="micro")
    hp, wp = (H + 7) // 8 * 8, (W + 127) // 128 * 128
    r.render(ts.update(DT))  # the eager warm-up makes it, then the capture
    words, arrivals = port.common.merge_scratch(cuda_device, hp, wp)
    r.render_batch_device(_advance(ts, 4))
    port.torch.cuda.synchronize()
    again = port.common.merge_scratch(cuda_device, hp, wp)
    assert again[0].data_ptr() == words.data_ptr()
    assert bool((words == -1).all()) and not bool(arrivals.any())


@pytest.mark.cuda
def test_batch_costs_three_host_calls_a_frame_on_card(port, cuda_device):
    from compute_renderer_torch.bench import profiling

    (ts,) = _scenes((port,))
    r = port.renderer.Renderer(ts.mesh, W, H, device=cuda_device)
    calls = profiling.host_calls_per_frame(r, lambda n: _advance(ts, n))
    assert calls is not None and calls <= 3


@pytest.mark.cuda
def test_staged_batches_equal_eager_on_card(port, cuda_device):
    # Batches staged row by row in the pinned buffers, submitted back to
    # back without a fence, then a fenced loop, a checked batch that
    # retries and the viewers' one-frame push: every frame bitwise the
    # eager frame of its uniforms.
    from compute_renderer_torch.app.window import FramePipe

    torch = port.torch
    tr = port.tracing
    (ts,) = _scenes((port,))
    r = port.renderer.Renderer(ts.mesh, W, H, device=cuda_device)
    r.render(ts.update(DT))  # capacities settle, off the staging buffers
    tr.reset()
    batches = [_advance(ts, k) for k in (64, 3, 1, 64)]
    staged = [r.render_batch_device(us, check=False) for us in batches]
    assert not r.flush_overflow()
    # Buffer one: 64 rows; buffer two: 4, then 64 at the fourth batch.
    assert tr.count("stage.grows") == 3
    assert tr.count("stage.waits") <= 2  # on batches still on the card
    for us, frames in zip(batches, staged):
        assert torch.equal(frames, r.render_batch_device(us, eager=True))
    # A fenced loop finds its buffers read: no grow, no wait.
    counts = tr.counters()
    for _ in range(4):
        us = _advance(ts, 64)
        frames = r.render_batch_device(us, check=False)
        r.fence_pending()
        assert torch.equal(frames, r.render_batch_device(us, eager=True))
    assert not r.flush_overflow()
    assert tr.count("stage.grows") == counts["stage.grows"]
    assert tr.count("stage.waits") == counts["stage.waits"]
    # A checked batch at a pinned pair capacity it outgrows: the retry
    # replays the rows as staged, at the grown capacity.
    small = port.renderer.Renderer(ts.mesh, W, H, device=cuda_device,
                                   path="micro", pair_cap=16)
    us = _advance(ts, 5)
    retries = tr.count("retries")
    frames = small.render_batch_device(us)
    assert tr.count("retries") == retries + 1
    assert torch.equal(frames, small.render_batch_device(us, eager=True))
    # The viewers' tick: one frame a batch through FramePipe, which shows
    # frame k-1 at tick k (tick 0: its own); no refill waits.
    pipe = FramePipe(cuda_device)
    waits = tr.count("stage.waits")
    ticks = _advance(ts, 6)
    shown = []
    for u in ticks:
        pipe.push(r.render_batch_device([u], check=False))
        shown.append(pipe.fetch().copy())
    assert not r.flush_overflow()
    assert tr.count("stage.waits") == waits
    eager = r.render_batch_device(ticks, eager=True).cpu().numpy()
    for k, frame in enumerate(shown):
        np.testing.assert_array_equal(frame, eager[max(k - 1, 0)])
    r.close()
    small.close()
