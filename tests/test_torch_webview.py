"""The port's HTTP viewer (``compute_renderer_torch/app/webview.py``)
driven over real HTTP on the CPU (``device="cpu"``).

The seven behaviours of tests/test_webview.py on an ephemeral 127.0.0.1
port, the PNG frames decoded with the standard library alone (the card's
machine has no Pillow); a served frame equals the presented one and lags
one tick; and the port against the JAX package's viewer under one fake
clock and one event sequence.

Tolerances: a served frame against the port's presented frame and a
render of the previous tick's uniforms bitwise; the camera state bitwise;
the port's presented frames against the JAX viewer's within the pixel
contract (at most max(2, H*W/500) pixels more than 2 LSB off).
"""

import json
import urllib.request

import numpy as np
import pytest

from tests.test_torch_cli import decode_png
from tests.test_torch_window import FakeClock
from tests.torch_parity import assert_frames_match, port  # noqa: F401

W, H = 64, 48


def _configs(pkg_scene, n=1, backend="cuda"):
    return [pkg_scene.SceneConfig(
        model_path="suzanne.obj", backend_type=backend,
        camera_config=pkg_scene.CameraConfig.first_person((0.0, 0.0, 3.0)),
        benchmark_duration_secs=None) for _ in range(n)]


@pytest.fixture(params=["xla", "cuda"])
def app(request):
    from compute_renderer_torch.app.webview import WebViewerApp
    from compute_renderer_torch.engine import scene

    a = WebViewerApp(_configs(scene, backend=request.param), W, H, port=0,
                     device="cpu")
    yield a
    a.shutdown()


def _get(app, path):
    with urllib.request.urlopen(
            f"http://127.0.0.1:{app.port}{path}", timeout=10) as r:
        return r.read(), dict(r.headers)


def _post(app, path, payload):
    req = urllib.request.Request(
        f"http://127.0.0.1:{app.port}{path}",
        data=json.dumps(payload).encode(), method="POST")
    with urllib.request.urlopen(req, timeout=10) as r:
        return r.read()


# -- the behaviours of tests/test_webview.py -----------------------------------

def test_page_and_frame_served(app):
    page, _ = _get(app, "/")
    assert b"<html" in page and b"/frame" in page and b"/input" in page

    app.tick()
    png, headers = _get(app, "/frame?since=0")
    assert png.startswith(b"\x89PNG")
    assert int(headers["X-Frame-No"]) >= 1
    assert "fps" in headers["X-HUD"]
    rgba = decode_png(png)
    assert rgba.shape == (H, W, 4)
    assert tuple(rgba[0, 0]) == (0, 0, 255, 255)
    assert (rgba[:, :, :3] != (0, 0, 255)).any(axis=-1).sum() > 20


def test_input_events_drive_camera(app):
    cam = app.scene.get_active_camera()
    before_eye = np.array(cam.eye, np.float32).copy()
    yaw_before = float(cam.yaw)

    _post(app, "/input", {"kind": "keydown", "key": "w"})
    _post(app, "/input", {"kind": "mousedown", "x": 10, "y": 10})
    _post(app, "/input", {"kind": "mousemove", "x": 30, "y": 10})
    _post(app, "/input", {"kind": "mouseup"})
    app.tick()  # drains the queue, then moves with dt

    assert "w" in app.keys_down
    assert float(cam.yaw) != yaw_before
    assert not np.allclose(np.array(cam.eye, np.float32), before_eye)

    _post(app, "/input", {"kind": "keyup", "key": "w"})
    app.tick()
    assert "w" not in app.keys_down


def test_frame_advances_and_cursor_waits(app):
    app.tick()
    _, h1 = _get(app, "/frame?since=0")
    n1 = int(h1["X-Frame-No"])
    app.tick()
    png2, h2 = _get(app, f"/frame?since={n1}")
    assert int(h2["X-Frame-No"]) == n1 + 1
    assert png2.startswith(b"\x89PNG")


def test_resize_rebuilds_step(app):
    _post(app, "/input", {"kind": "resize", "w": 96, "h": 64})
    app.tick()
    png, _ = _get(app, "/frame?since=0")
    assert decode_png(png).shape == (64, 96, 4)


def test_escape_reloads_scene_and_quit_stops(app):
    renderer_before = app.renderer
    _post(app, "/input", {"kind": "keydown", "key": "escape"})
    app.tick()
    assert app.renderer is not renderer_before  # scene reloaded

    _post(app, "/quit", {})
    app.tick()
    assert not app.running


def test_single_scene_benchmark_end_exits(app):
    app._next_scene_or_exit()
    assert not app.running


def test_stats_endpoint(app):
    app.tick()
    body, _ = _get(app, "/stats")
    stats = json.loads(body)
    assert stats["width"] == W and stats["height"] == H
    assert stats["frames"] >= 1 and "suzanne" in stats["scene"]
    # The host counters beside fps: ints, the CPU replays no graph.
    counters = ("captures", "graph_drops", "retries", "calibrations",
                "tunes", "replays", "stage.grows", "stage.waits")
    assert stats["fps"] >= 0.0
    assert all(isinstance(stats[k], int) and stats[k] >= 0
               for k in counters), stats
    assert stats["captures"] == stats["replays"] == 0


# -- the pipelined present -----------------------------------------------------

def test_served_frame_lags_one_tick(port):
    # One blocking wait a tick and no checked render; the PNG served after
    # tick k is the render of tick k-1's uniforms (tick 0: its own).
    from compute_renderer_torch.app.webview import WebViewerApp
    from compute_renderer_torch.engine import scene

    app = WebViewerApp(_configs(scene), W, H, port=0, device="cpu")
    try:
        uniforms, fetches, checked = [], [], []
        update, fetch = app.scene.update, app._fetch
        app.scene.update = lambda dt: (uniforms.append(update(dt)),
                                       uniforms[-1])[1]
        app._fetch = lambda: (fetches.append(1), fetch())[1]
        app.renderer.render = lambda u: checked.append(1)
        ref = port.renderer.Renderer(app.scene.mesh, W, H, device="cpu",
                                     **app.scene.renderer_options())
        _post(app, "/input", {"kind": "keydown", "key": "w"})
        for k in range(4):
            if k == 2:
                _post(app, "/input", {"kind": "mousedown", "x": 3, "y": 3})
                _post(app, "/input", {"kind": "mousemove", "x": 20, "y": 8})
            app.tick()
            png, headers = _get(app, f"/frame?since={k}")
            assert int(headers["X-Frame-No"]) == k + 1
            want = ref.render(uniforms[max(k - 1, 0)])
            np.testing.assert_array_equal(decode_png(png), want)
        assert len(fetches) == 4 and not checked
    finally:
        app.shutdown()


def test_viewer_on_cuda_raises_without_card(port):
    # The renderer refuses "cuda" without a card, and the server it started
    # is shut down (its port is free again).
    import socket

    from compute_renderer_torch.app.webview import WebViewerApp
    from compute_renderer_torch.engine import scene

    if port.torch.cuda.is_available():
        pytest.skip("a card is present: the viewer runs there")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        free = s.getsockname()[1]
    with pytest.raises(RuntimeError, match="NVIDIA GPU"):
        WebViewerApp(_configs(scene), W, H, port=free)
    with socket.socket() as s:
        s.bind(("127.0.0.1", free))


# -- against the JAX package's viewer -----------------------------------------

EVENTS = [
    [],
    [{"kind": "keydown", "key": "w"}],
    [{"kind": "mousedown", "x": 10, "y": 10},
     {"kind": "mousemove", "x": 30, "y": 14}],
    [{"kind": "mouseup"}, {"kind": "keyup", "key": "w"},
     {"kind": "resize", "w": 96, "h": 64}],
    [],
    [{"kind": "keydown", "key": "escape"}],
    [{"kind": "keydown", "key": "a"}],
    [],
]


@pytest.mark.parametrize("backend", ["xla", "cuda"])
def test_frame_parity_with_jax_viewer(backend, monkeypatch):
    from compute_renderer_tpu.app import webview as jax_webview
    from compute_renderer_tpu.engine import scene as jax_scene
    from compute_renderer_torch.app import webview as port_webview
    from compute_renderer_torch.engine import scene as port_scene

    monkeypatch.setattr(jax_webview, "time", FakeClock())
    monkeypatch.setattr(port_webview, "time", FakeClock())
    japp = jax_webview.WebViewerApp(_configs(jax_scene, 2, "xla"), W, H,
                                    port=0)
    papp = port_webview.WebViewerApp(_configs(port_scene, 2, backend), W, H,
                                     port=0, device="cpu")
    try:
        shown = {id(japp): [], id(papp): []}
        for a in (japp, papp):
            present = a._present
            a._present = (lambda rgba, a=a, present=present: (
                shown[id(a)].append(np.array(rgba)), present(rgba))[1])
        for batch in EVENTS:
            for a in (japp, papp):
                for ev in batch:
                    _post(a, "/input", ev)
                a.tick()
            jc = japp.scene.get_active_camera()
            pc = papp.scene.get_active_camera()
            np.testing.assert_array_equal(np.asarray(jc.eye),
                                          np.asarray(pc.eye))
            assert (jc.yaw, jc.pitch) == (pc.yaw, pc.pitch)
            js, ps = japp.stats(), papp.stats()
            assert js.pop("scene").replace("xla", backend) == ps.pop("scene")
            # Beside the JAX viewer's figures the port reports its host
            # counters (tracing.counters()).
            counters = {k: ps.pop(k) for k in set(ps) - set(js)}
            assert js == ps
            assert set(counters) == {"captures", "graph_drops", "retries",
                                     "calibrations", "tunes", "replays",
                                     "stage.grows", "stage.waits"}
            assert_frames_match(shown[id(japp)][-1], shown[id(papp)][-1])
            png, _ = _get(papp, "/frame?since=0")
            np.testing.assert_array_equal(decode_png(png),
                                          shown[id(papp)][-1])
        assert papp.scene_index == 1 and papp.width == 96
    finally:
        japp.shutdown()
        papp.shutdown()
