"""The port's display window (``compute_renderer_torch/app/window.py``)
on the CPU, through a copy of the fake Tk of tests/test_window.py.

The ten behaviours of tests/test_window.py on the port with
``device="cpu"``, for the brute-force comparator ("xla") and the engine's
twins ("cuda"); the pipelined present (``FramePipe``): the frame shown at
tick k is the render of tick k-1's uniforms; and the port against the JAX
package's viewer under one fake clock and one event sequence.

Tolerances: the camera state (eye, yaw, pitch) bitwise; a presented frame
against a render of the same uniforms within the port bitwise; the port's
blitted frames against the JAX viewer's within the pixel contract (at most
max(2, H*W/500) pixels more than 2 LSB off: XLA:CPU contracts mul+add
into FMA on exact edges).
"""

from types import SimpleNamespace

import numpy as np
import pytest

from tests.torch_parity import assert_frames_match, cuda_device, port  # noqa: F401

DT = 1.0 / 60.0
BACKENDS = ["xla", "cuda"]


class FakeWidget:
    """Tk's root and canvas, as tests/test_window.py fakes them (that
    module imports the JAX package, which the card's machine lacks)."""

    def __init__(self, *a, **k):
        self.bindings = {}
        self.images = []
        self.destroyed = False
        self.after_calls = []
        self.text_items = {}

    def title(self, *_):
        pass

    def pack(self, *_, **__):
        pass

    def config(self, **_):
        pass

    def bind(self, event, fn):
        self.bindings[event] = fn

    def create_image(self, *a, **k):
        self.images.append((a, k))

    def create_text(self, *a, **k):
        item = len(self.text_items) + 1
        self.text_items[item] = k
        return item

    def itemconfigure(self, item, **k):
        self.text_items[item].update(k)

    def tag_raise(self, item):
        pass

    def after(self, ms, fn):
        self.after_calls.append(fn)

    def destroy(self):
        self.destroyed = True

    def mainloop(self):
        pass


class FakePhoto:
    instances: list = []

    def __init__(self, data=None, format=None):
        self.data = data
        self.format = format
        FakePhoto.instances.append(self)


def fake_tk():
    FakePhoto.instances = []
    return SimpleNamespace(Tk=FakeWidget, Canvas=FakeWidget,
                           PhotoImage=FakePhoto)


def make_app(backend, w=64, h=48, duration=None, n_scenes=1):
    from compute_renderer_torch.app.window import InteractiveApp
    from compute_renderer_torch.engine.scene import CameraConfig, SceneConfig

    # First-person camera so WASD / mouse-look are live (camera.rs:97-173).
    cfgs = [
        SceneConfig(model_path="suzanne.obj", backend_type=backend,
                    camera_config=CameraConfig.first_person((0.0, 0.0, 3.0)),
                    benchmark_duration_secs=duration)
        for _ in range(n_scenes)
    ]
    return InteractiveApp(cfgs, w, h, tk_module=fake_tk(), device="cpu")


def ppm_pixels(photo, w, h):
    header = f"P6 {w} {h} 255 ".encode()
    assert photo.data.startswith(header)
    return np.frombuffer(photo.data[len(header):], np.uint8).reshape(h, w, 3)


class FakeClock:
    """``time`` for a viewer module: perf_counter advances by DT a call
    (one call at start-up, one a tick)."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        now = self.t
        self.t += DT
        return now


# -- the behaviours of tests/test_window.py ----------------------------------

@pytest.mark.parametrize("backend", BACKENDS)
def test_tick_renders_and_blits(backend):
    app = make_app(backend)
    app._tick()
    assert app.photo is not None and app.photo.format == "PPM"
    header = f"P6 {app.width} {app.height} 255 ".encode()
    assert app.photo.data.startswith(b"P6 64 48 255 ")
    assert len(app.photo.data) == len(header) + 64 * 48 * 3
    pixels = ppm_pixels(app.photo, 64, 48)
    assert tuple(pixels[0, 0]) == (0, 0, 255)
    assert app.root.after_calls


@pytest.mark.parametrize("backend", BACKENDS)
def test_keyboard_moves_first_person_camera(backend):
    app = make_app(backend)
    cam = app.scene.get_active_camera()
    before = np.array(cam.eye, np.float32).copy()
    app._on_key_press(SimpleNamespace(keysym="w"))
    assert "w" in app.keys_down
    cam.process_keyboard(app.keys_down, 0.1)
    assert not np.allclose(np.array(cam.eye, np.float32), before)
    app._on_key_release(SimpleNamespace(keysym="w"))
    assert "w" not in app.keys_down


@pytest.mark.parametrize("backend", BACKENDS)
def test_mouse_drag_changes_look(backend):
    app = make_app(backend)
    cam = app.scene.get_active_camera()
    yaw_before = float(cam.yaw)
    app._on_mouse_down(SimpleNamespace(x=10, y=10))
    app._on_mouse_move(SimpleNamespace(x=30, y=10))
    assert float(cam.yaw) != yaw_before


@pytest.mark.parametrize("backend", BACKENDS)
def test_escape_cycles_scene(backend):
    app = make_app(backend, n_scenes=2)
    first_scene = app.scene
    app._on_key_press(SimpleNamespace(keysym="Escape"))
    assert app.scene_index == 1 and app.scene is not first_scene


@pytest.mark.parametrize("backend", BACKENDS)
def test_resize_rebuilds_step(backend):
    app = make_app(backend)
    app._on_resize(SimpleNamespace(width=96, height=64))
    assert (app.width, app.height) == (96, 64)
    app._tick()
    assert app.photo.data.startswith(b"P6 96 64 255 ")
    assert tuple(ppm_pixels(app.photo, 96, 64)[0, 0]) == (0, 0, 255)


@pytest.mark.parametrize("backend", BACKENDS)
def test_benchmark_end_auto_cycles_then_exits(backend):
    app = make_app(backend, duration=0.0, n_scenes=2)
    app.collector.warmup = 0.0
    app._tick()  # starts scene 0's clock
    app._tick()  # ends scene 0 -> cycles to scene 1
    assert app.scene_index == 1 and app.running
    app.collector.warmup = 0.0
    app._tick()
    app._tick()  # ends scene 1 -> last scene: exit
    assert not app.running and app.root.destroyed


@pytest.mark.parametrize("backend", BACKENDS)
def test_tick_single_roundtrip_per_frame(backend):
    # Per tick exactly ONE blocking wait (the previous frame's pixels) and
    # ZERO calls to the checked render path.
    app = make_app(backend)
    fetches = []
    checked = []
    orig_fetch = app._fetch
    app._fetch = lambda: (fetches.append(1), orig_fetch())[1]
    orig_render = app.renderer.render
    app.renderer.render = lambda u: (checked.append(1), orig_render(u))[1]
    n = 6
    for _ in range(n):
        app._tick()
    assert len(fetches) == n, f"{len(fetches)} blocking fetches for {n} ticks"
    assert not checked, "viewer used the checked render path"
    assert app.photo is not None and app.photo.format == "PPM"


@pytest.mark.parametrize("backend", BACKENDS)
def test_tick_overflow_flush_recovers(backend):
    from compute_renderer_torch.app import window as window_mod

    app = make_app(backend)
    app._tick()
    app._tick_count = window_mod.FLUSH_INTERVAL - 1  # next tick flushes
    app.renderer.flush_overflow = lambda: True
    checked = []
    orig_render = app.renderer.render
    app.renderer.render = lambda u: (checked.append(1), orig_render(u))[1]
    app._tick()
    assert checked, "overflow flush did not trigger a checked render"
    assert not app._pipe._inflight  # pipeline restarted


@pytest.mark.parametrize("backend", BACKENDS)
def test_hud_shows_fps(backend):
    app = make_app(backend)
    app._tick()
    app._tick()
    assert app._hud is not None
    hud = app.canvas.text_items[app._hud]
    assert hud["text"].strip().endswith("fps")


@pytest.mark.parametrize("backend", BACKENDS)
def test_run_interactive_raises_cleanly_without_display(backend):
    import os

    from compute_renderer_torch.app.window import run_interactive
    from compute_renderer_torch.engine.scene import SceneConfig

    if os.environ.get("DISPLAY"):
        pytest.skip("display present; covered interactively")
    cfg = SceneConfig(model_path="suzanne.obj", backend_type=backend)
    with pytest.raises(RuntimeError, match="headless"):
        run_interactive(cfg, 64, 48, device="cpu")


# -- the pipelined present -----------------------------------------------------

def _record(app):
    """Lists the app fills: each tick's uniforms and each blitted frame
    (a copy: the pipe's host buffers are reused)."""
    uniforms, shown = [], []
    update = app.scene.update
    blit = app._blit

    def scene_update(dt):
        u = update(dt)
        uniforms.append(u)
        return u

    app.scene.update = scene_update
    app._blit = lambda rgba: (shown.append(np.array(rgba)), blit(rgba))[1]
    return uniforms, shown


def test_presented_frame_lags_one_tick(port):
    # Tick 0 presents its own frame (warm-up); tick k >= 1 presents the
    # render of tick k-1's uniforms, bitwise.
    app = make_app("cuda")
    uniforms, shown = _record(app)
    app._on_key_press(SimpleNamespace(keysym="w"))
    for k in range(5):
        if k == 2:
            app._on_mouse_down(SimpleNamespace(x=5, y=5))
            app._on_mouse_move(SimpleNamespace(x=25, y=9))
        app._tick()
    ref = port.renderer.Renderer(app.scene.mesh, 64, 48, device="cpu",
                                 **app.scene.renderer_options())
    frames = [ref.render(u) for u in uniforms]
    np.testing.assert_array_equal(shown[0], frames[0])
    for k in range(1, len(shown)):
        np.testing.assert_array_equal(shown[k], frames[k - 1])
    assert not np.array_equal(frames[0], frames[-1])  # the camera moved


def test_frame_pipe_on_cpu(port):
    from compute_renderer_torch.app.window import FramePipe

    torch = port.torch
    pipe = FramePipe("cpu")
    a = torch.full((1, 4, 5, 4), 7, dtype=torch.uint8)
    b = torch.full((1, 4, 5, 4), 9, dtype=torch.uint8)
    pipe.push(a)
    assert (pipe.fetch() == 7).all()  # warm-up: the frame just pushed
    pipe.push(b)
    assert (pipe.fetch() == 7).all()  # then the one before
    a.fill_(1)  # the host copy does not alias the device frame
    pipe.push(a)
    assert (pipe.fetch() == 9).all()
    pipe.reset()
    c = torch.zeros((1, 2, 3, 4), dtype=torch.uint8)
    pipe.push(c)
    assert pipe.fetch().shape == (2, 3, 4)


def test_viewer_on_cuda_raises_without_card(port):
    from compute_renderer_torch.app.window import InteractiveApp
    from compute_renderer_torch.engine.scene import SceneConfig

    if port.torch.cuda.is_available():
        pytest.skip("a card is present: the viewer runs there")
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        InteractiveApp([SceneConfig()], 64, 48, tk_module=fake_tk())


# -- against the JAX package's viewer -----------------------------------------

def _drive(app, step):
    """The event sequence of the parity test, one tick at a time; yields
    after each tick."""
    events = [
        [],
        [("key", "w")],
        [],
        [("down", 10, 10), ("move", 30, 14)],
        [("move", 36, 20), ("up",)],
        [("release", "w"), ("resize", 96, 64)],
        [],
        [("key", "Escape")],
        [("key", "d")],
        [],
    ]
    for batch in events:
        for ev in batch:
            if ev[0] == "key":
                app._on_key_press(SimpleNamespace(keysym=ev[1]))
            elif ev[0] == "release":
                app._on_key_release(SimpleNamespace(keysym=ev[1]))
            elif ev[0] == "down":
                app._on_mouse_down(SimpleNamespace(x=ev[1], y=ev[2]))
            elif ev[0] == "move":
                app._on_mouse_move(SimpleNamespace(x=ev[1], y=ev[2]))
            elif ev[0] == "up":
                app._on_mouse_up(SimpleNamespace())
            elif ev[0] == "resize":
                app._on_resize(SimpleNamespace(width=ev[1], height=ev[2]))
        step(app)
        yield app


@pytest.mark.parametrize("backend", BACKENDS)
def test_parity_with_jax_viewer(backend, monkeypatch):
    from compute_renderer_tpu.app import window as jax_window
    from compute_renderer_tpu.engine.scene import (
        CameraConfig as JCameraConfig, SceneConfig as JSceneConfig,
    )
    from compute_renderer_torch.app import window as port_window
    from compute_renderer_torch.engine.scene import CameraConfig, SceneConfig

    monkeypatch.setattr(jax_window, "time", FakeClock())
    monkeypatch.setattr(port_window, "time", FakeClock())
    jcfgs = [JSceneConfig(model_path="suzanne.obj", backend_type="xla",
                          camera_config=JCameraConfig.first_person(
                              (0.0, 0.0, 3.0)))
             for _ in range(2)]
    pcfgs = [SceneConfig(model_path="suzanne.obj", backend_type=backend,
                         camera_config=CameraConfig.first_person(
                             (0.0, 0.0, 3.0)))
             for _ in range(2)]
    japp = jax_window.InteractiveApp(jcfgs, 64, 48, tk_module=fake_tk())
    papp = port_window.InteractiveApp(pcfgs, 64, 48, tk_module=fake_tk(),
                                      device="cpu")
    ticks = 0
    for ja, pa in zip(_drive(japp, lambda a: a._tick()),
                      _drive(papp, lambda a: a._tick())):
        ticks += 1
        jc, pc = ja.scene.get_active_camera(), pa.scene.get_active_camera()
        np.testing.assert_array_equal(np.asarray(jc.eye), np.asarray(pc.eye))
        assert (jc.yaw, jc.pitch) == (pc.yaw, pc.pitch)
        assert (ja.width, ja.height, ja.scene_index) == (
            pa.width, pa.height, pa.scene_index)
        assert_frames_match(ppm_pixels(ja.photo, ja.width, ja.height),
                            ppm_pixels(pa.photo, pa.width, pa.height))
    assert ticks == 10 and papp.scene_index == 1 and papp.width == 96


# -- on the card --------------------------------------------------------------

@pytest.mark.cuda
def test_pipelined_present_on_card(port, cuda_device):
    # The frame shown at tick k is tick k-1's render, bitwise, through the
    # pinned buffers and events; a fetched frame survives the next replay.
    from compute_renderer_torch.app.window import InteractiveApp
    from compute_renderer_torch.engine.scene import CameraConfig, SceneConfig

    cfg = SceneConfig(model_path="suzanne.obj",
                      camera_config=CameraConfig(distance=3.0))
    app = InteractiveApp([cfg], 128, 96, tk_module=fake_tk(),
                         device=cuda_device)
    uniforms, shown = _record(app)
    for _ in range(6):
        app._tick()
    ref = port.renderer.Renderer(app.scene.mesh, 128, 96, device=cuda_device,
                                 **app.scene.renderer_options())
    frames = [ref.render(u) for u in uniforms]
    np.testing.assert_array_equal(shown[0], frames[0])
    for k in range(1, len(shown)):
        np.testing.assert_array_equal(shown[k], frames[k - 1])
    assert len(FakePhoto.instances) == 6
