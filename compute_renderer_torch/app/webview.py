"""Browser-based interactive viewer: the headless-box "window".

The port's copy of the JAX package's ``app/webview.py``: the same routes,
page, event queue and frame loop, on ``device`` ("cuda", the default,
raises without a card; "cpu" runs the torch twins).

The reference's window is a winit OS window (src/window.rs:37-99); the Tk
viewer (app/window.py) is its direct analog and needs a local display. A
GPU host is normally a headless machine in a datacenter, so the idiomatic
"window" for it is a browser tab: this module serves the interactive app
over HTTP on 127.0.0.1 — the framebuffer as PNG frames, and
keyboard/mouse/resize events posted back from the page.

Same frame-loop contract as the Tk viewer (window.rs:194-221 semantics):

- pipelined present (``window.FramePipe``): frame k is dispatched
  (unchecked) and its copy enqueued before frame k-1's pixels are
  presented — one blocking wait per tick;
- binning-overflow flags flushed every FLUSH_INTERVAL ticks, one checked
  render growing capacities on overflow;
- first-person WASD/Space/C + Shift sprint + [ ] trim + P pose print
  (camera.rs:97-150), pointer-drag mouse look (camera.rs:152-173);
- Escape cycles scenes; benchmark-duration end finalises the collector and
  advances (window.rs:203-209, 274-342); resize re-renders at the new
  size (window.rs:137-169).

Input events arrive on HTTP handler threads and are queued; the render
loop drains the queue at the start of each tick — the same
events-between-frames model Tk's event loop gives the sibling viewer. The
handler threads never touch torch: only the tick thread renders.
"""

from __future__ import annotations

import json
import queue
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from compute_renderer_torch import tracing
from compute_renderer_torch.app.headless import encode_png
from compute_renderer_torch.app.window import FLUSH_INTERVAL, FramePipe
from compute_renderer_torch.bench.collector import PerformanceCollector
from compute_renderer_torch.engine.renderer import Renderer
from compute_renderer_torch.engine.scene import Scene, SceneConfig

# Browser KeyboardEvent.key -> camera key names (same set as the Tk
# viewer's _KEYMAP; the names are what Camera.process_keyboard expects).
_KEYMAP = {
    "w": "w", "a": "a", "s": "s", "d": "d",
    " ": "space", "c": "c",
    "shift": "shift",
    "[": "[", "]": "]",
    "p": "p",
}

_PAGE = """<!doctype html>
<html><head><title>compute-renderer-tpu</title><style>
  html,body { margin:0; background:#111; height:100%; overflow:hidden; }
  #v { display:block; image-rendering:pixelated; outline:none; }
  #hud { position:fixed; top:6px; left:6px; color:#fff;
         font:10px monospace; text-shadow:0 0 2px #000; }
</style></head>
<body>
<img id="v" draggable="false">
<div id="hud"></div>
<script>
const v = document.getElementById('v');
const hud = document.getElementById('hud');
let lastUrl = null;
function post(ev) {
  fetch('/input', {method:'POST', body:JSON.stringify(ev)});
}
async function frames() {
  let seen = 0;
  for (;;) {
    try {
      const r = await fetch('/frame?since=' + seen, {cache:'no-store'});
      if (!r.ok) break;
      seen = parseInt(r.headers.get('X-Frame-No') || '0');
      hud.textContent = r.headers.get('X-HUD') || '';
      const url = URL.createObjectURL(await r.blob());
      v.src = url;
      if (lastUrl) URL.revokeObjectURL(lastUrl);
      lastUrl = url;
    } catch (e) { break; }
  }
}
function keyname(e) {
  return e.key.length === 1 ? e.key.toLowerCase() : e.key.toLowerCase();
}
window.addEventListener('keydown', e => {
  post({kind:'keydown', key:keyname(e)}); e.preventDefault();
});
window.addEventListener('keyup', e => {
  post({kind:'keyup', key:keyname(e)}); e.preventDefault();
});
v.addEventListener('pointerdown', e => {
  v.setPointerCapture(e.pointerId);
  post({kind:'mousedown', x:e.offsetX, y:e.offsetY});
});
v.addEventListener('pointerup', e => post({kind:'mouseup'}));
v.addEventListener('pointermove', e => {
  if (e.buttons & 1) post({kind:'mousemove', x:e.offsetX, y:e.offsetY});
});
window.addEventListener('resize', () => post(
  {kind:'resize', w:window.innerWidth, h:window.innerHeight}));
frames();
</script>
</body></html>
"""


def _encode_png(rgba: np.ndarray) -> bytes:
    """(H,W,4) uint8 -> PNG bytes with the standard library (no Pillow on
    the card's machine). zlib level 1: the viewer re-encodes every frame;
    favor rate over ratio (localhost link, ~3 MB/frame raw at 1024x768)."""
    return encode_png(rgba, level=1)


class WebViewerApp:
    """The interactive app served over HTTP (see module docstring)."""

    def __init__(self, scene_configs: list, width: int, height: int,
                 port: int = 8700, *, device="cuda"):
        self.device = torch.device(device)
        self.scene_configs = scene_configs
        self.scene_index = 0
        self.width = width
        self.height = height
        self.keys_down: set = set()
        self.mouse_down = False
        self.last_mouse = (0, 0)
        self.running = True
        self.events: queue.Queue = queue.Queue()

        # Latest presented frame (PNG) + a condition so /frame can wait for
        # the next one instead of re-serving duplicates at poll rate.
        self._png = _encode_png(
            np.zeros((height, width, 4), np.uint8) + np.uint8(32))
        self._frame_no = 0
        self._cond = threading.Condition()

        self._pipe = FramePipe(self.device)
        self._tick_count = 0
        self._fps = 0.0

        app = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, *a):  # quiet server
                pass

            def _send(self, code, body, ctype, extra=()):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.send_header("Cache-Control", "no-store")
                for k, v in extra:
                    self.send_header(k, v)
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                if self.path == "/" or self.path.startswith("/index"):
                    self._send(200, _PAGE.encode(), "text/html")
                elif self.path.startswith("/frame"):
                    since = 0
                    if "since=" in self.path:
                        try:
                            since = int(
                                self.path.split("since=", 1)[1]
                                .split("&", 1)[0])
                        except ValueError:
                            pass
                    png, no, hud = app.wait_frame(since)
                    self._send(200, png, "image/png",
                               [("X-HUD", hud), ("X-Frame-No", str(no))])
                elif self.path.startswith("/stats"):
                    self._send(200, json.dumps(app.stats()).encode(),
                               "application/json")
                else:
                    self._send(404, b"not found", "text/plain")

            def do_POST(self):
                if self.path.startswith("/input"):
                    n = int(self.headers.get("Content-Length", 0))
                    try:
                        ev = json.loads(self.rfile.read(n) or b"{}")
                    except ValueError:
                        ev = {}
                    app.events.put(ev)
                    self._send(200, b"ok", "text/plain")
                elif self.path.startswith("/quit"):
                    app.running = False
                    self._send(200, b"bye", "text/plain")
                else:
                    self._send(404, b"not found", "text/plain")

        self.server = ThreadingHTTPServer(("127.0.0.1", port), Handler)
        self.port = self.server.server_address[1]
        self._server_thread = threading.Thread(
            target=self.server.serve_forever, daemon=True)
        self._server_thread.start()

        try:
            self._load_scene(0)
        except BaseException:
            self.shutdown()  # a renderer that cannot start frees the port
            raise
        self.last_frame = time.perf_counter()

    # -- scene management (window.rs:274-342, as app/window.py) --------------

    def _load_scene(self, index: int) -> None:
        self._pipe.reset()
        self.scene_index = index % len(self.scene_configs)
        config = self.scene_configs[self.scene_index]
        self.scene = Scene.from_config(config, self.width, self.height)
        self.renderer = Renderer(self.scene.mesh, self.width, self.height,
                                 backend=config.normalized_backend(),
                                 device=self.device,
                                 **self.scene.renderer_options())
        self.collector = PerformanceCollector(
            config.scene_name(), self.scene_index,
            config.benchmark_duration_secs,
            num_triangles=self.scene.mesh.num_triangles,
            num_pixels=self.width * self.height,
        )

    def _next_scene_or_exit(self) -> None:
        self.collector.finalise()
        if self.scene_index + 1 >= len(self.scene_configs):
            self.running = False
            return
        self._load_scene(self.scene_index + 1)

    # -- input (drained on the render thread each tick) ----------------------

    def _apply_event(self, ev: dict) -> None:
        kind = ev.get("kind")
        if kind == "keydown":
            key = str(ev.get("key", "")).lower()
            if key == "escape":
                self._load_scene(self.scene_index + 1)
            elif key in _KEYMAP:
                self.keys_down.add(_KEYMAP[key])
        elif kind == "keyup":
            key = str(ev.get("key", "")).lower()
            if key in _KEYMAP:
                self.keys_down.discard(_KEYMAP[key])
        elif kind == "mousedown":
            self.mouse_down = True
            self.last_mouse = (int(ev.get("x", 0)), int(ev.get("y", 0)))
        elif kind == "mouseup":
            self.mouse_down = False
        elif kind == "mousemove" and self.mouse_down:
            x, y = int(ev.get("x", 0)), int(ev.get("y", 0))
            dx = x - self.last_mouse[0]
            dy = self.last_mouse[1] - y  # y inverted like mouse-look
            self.last_mouse = (x, y)
            camera = self.scene.get_active_camera()
            if camera is not None:
                camera.process_mouse(float(dx), float(dy))
        elif kind == "resize":
            w, h = int(ev.get("w", 0)), int(ev.get("h", 0))
            if (w, h) == (self.width, self.height) or w < 16 or h < 16:
                return
            self.width, self.height = w, h
            self._pipe.reset()
            camera = self.scene.get_active_camera()
            if camera is not None:
                camera.set_aspect_ratio(w / h)
            self.renderer.resize(w, h)

    # -- present --------------------------------------------------------------

    def _fetch(self) -> np.ndarray:
        """The one blocking wait of a tick (``FramePipe.fetch``)."""
        return self._pipe.fetch()

    def _present(self, rgba: np.ndarray) -> None:
        png = _encode_png(rgba)
        with self._cond:
            self._png = png
            self._frame_no += 1
            self._cond.notify_all()

    def wait_frame(self, since: int = 0, timeout: float = 2.0):
        """Block until a frame newer than ``since`` (the client's last seen
        frame number) is presented, or timeout -> latest; returns
        (png_bytes, frame_no, hud_text)."""
        with self._cond:
            self._cond.wait_for(lambda: self._frame_no > since or
                                not self.running, timeout)
            hud = (f"{self._fps:5.1f} fps  "
                   f"{self.scene_configs[self.scene_index].scene_name()}")
            return self._png, self._frame_no, hud

    def stats(self) -> dict:
        """The page's figures, and beside fps the process's host counters
        of ``tracing.counters()``: captures, graph drops, retries,
        calibrations, tunings, replays and the staging buffers' growths
        and waits."""
        counts = tracing.counters()
        return {
            "fps": round(self._fps, 1),
            **{name: counts[name] for name in tracing.EVENTS},
            "scene": self.scene_configs[self.scene_index].scene_name(),
            "scene_index": self.scene_index,
            "width": self.width,
            "height": self.height,
            "frames": self._frame_no,
        }

    # -- frame loop (window.rs:194-221, as app/window.py _tick) ---------------

    def tick(self) -> None:
        while True:  # drain queued browser events
            try:
                self._apply_event(self.events.get_nowait())
            except queue.Empty:
                break
        if not self.running:
            return
        now = time.perf_counter()
        dt = now - self.last_frame
        self.last_frame = now
        if dt > 0:
            self._fps = 0.9 * self._fps + 0.1 / dt

        camera = self.scene.get_active_camera()
        if camera is not None:
            camera.update_over_time(dt)
            camera.process_keyboard(self.keys_down, dt)
        uniforms = self.scene.update(dt)

        self._tick_count += 1
        if (self._tick_count % FLUSH_INTERVAL == 0
                and self.renderer.flush_overflow()):
            self._pipe.reset()
            self._present(self.renderer.render(uniforms))
        else:
            self._pipe.push(self.renderer.render_batch_device(
                [uniforms], check=False))
            self._present(self._fetch())

        if self.collector.update():
            self._next_scene_or_exit()

    def run(self) -> None:
        print(f"web viewer: http://127.0.0.1:{self.port}/", flush=True)
        try:
            while self.running:
                self.tick()
        finally:
            self.shutdown()

    def shutdown(self) -> None:
        self.running = False
        with self._cond:
            self._cond.notify_all()
        self.server.shutdown()
        self.server.server_close()


def run_web(config: SceneConfig, width: int, height: int,
            port: int = 8700, device="cuda") -> None:
    WebViewerApp([config], width, height, port=port, device=device).run()
