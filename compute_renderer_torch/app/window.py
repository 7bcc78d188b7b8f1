"""Interactive viewer (reference src/window.rs) on top of tkinter.

The port's copy of the JAX package's ``app/window.py``: the same frame
loop, keys, mouse look, scene cycling and resize, on ``device`` ("cuda",
the default, raises without a card; "cpu" runs the torch twins).

Feature map from the reference's winit ApplicationHandler:
- per-frame update loop: dt -> camera -> scene update -> render -> blit
  (window.rs:194-221, 345-410), PIPELINED: frame k is dispatched
  (unchecked, a replay of the frame's CUDA graph) and its device->host
  copy enqueued before frame k-1's pixels are presented, so the card
  renders k while the host blits k-1 (``FramePipe``): one blocking wait a
  frame. Binning-overflow flags accumulate on the device and are flushed
  every few frames; an overflow triggers one checked render that grows
  capacities from the reported need.
- measured FPS in a HUD overlay (reference prints FPS to the collector)
- first-person WASD/Space/C + Shift sprint + [ ] speed trim ('P' prints the
  pose) (camera.rs:97-150) and mouse-drag look (camera.rs:152-173)
- Escape cycles to the next scene config (window.rs:274-342)
- benchmark-end auto-cycling: when a scene's benchmark duration elapses the
  collector finalises and the next SceneConfig loads; after the last one the
  app exits (window.rs:203-209, 274-281)
- window resize re-renders at the new size (window.rs:137-169; the
  renderer drops its graphs)

tkinter is used because it ships with CPython — no extra GUI dependency.
Requires a display; the CLI falls back to headless rendering otherwise. The
``tk_module`` hook exists so the frame loop, input handling, and scene
cycling are testable on displayless boxes (tests/test_torch_window.py
drives a fake Tk through ticks, keys, mouse, resize, and benchmark
cycling).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from compute_renderer_torch import tracing
from compute_renderer_torch.bench.collector import PerformanceCollector
from compute_renderer_torch.engine.renderer import Renderer
from compute_renderer_torch.engine.scene import Scene, SceneConfig

# Ticks between device-side overflow-flag flushes (each flush is one extra
# round trip; an overflowed frame shows with dropped triangles for at most
# this many frames before the checked re-render fixes capacities).
FLUSH_INTERVAL = 32

_KEYMAP = {
    "w": "w", "a": "a", "s": "s", "d": "d",
    "space": "space", "c": "c",
    "shift_l": "shift", "shift_r": "shift",
    "bracketleft": "[", "bracketright": "]",
    "p": "p",
}


class FramePipe:
    """The pipelined present of both viewers: ``push`` frame k, then
    ``fetch`` presents frame k-1 — one blocking wait a tick.

    On the card ``push`` enqueues the frame's copy into one of two pinned
    host buffers (``host[k % 2]``) behind the frame's render and records
    an event; ``fetch`` synchronizes on frame k-1's event only. Frame
    k-1's copy was enqueued before frame k's render, so the wait does not
    cover frame k, which the card renders while the host presents k-1.
    On warm-up (the first push after ``reset``) ``fetch`` waits on the
    frame just pushed and presents it. The pushed device frame is held
    until its event has fired. On the CPU the copy is synchronous and
    there are no events.

    The array ``fetch`` returns is a view of a host buffer that the next
    push overwrites: present it (or copy it) before then."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.reset()

    def reset(self) -> None:
        """Drop the frames in flight and the host buffers (a scene load,
        a resize, an overflow's checked render): the next push warms the
        pipeline up again at its frame's size. A buffer dropped with a
        copy still pending stays alive until the copy ends (the pinned
        allocator records the copy's stream)."""
        self._host = None
        self._slot = 0
        self._inflight = []  # [(device frames, slot, event)], oldest first

    def push(self, frames) -> None:
        """Enqueue the copy of ``frames[0]``, a device (1, H, W, 4) u8
        frame that the renderer returned fresh (never a graph's static
        output), into the next host buffer (the span ``pipe.push``)."""
        with tracing.span("pipe.push"):
            frame = frames[0]
            if self._host is None or self._host[0].shape != frame.shape:
                pinned = self.device.type == "cuda"
                self._host = [torch.empty(frame.shape, dtype=torch.uint8,
                                          pin_memory=pinned)
                              for _ in range(2)]
            slot = self._slot
            self._slot ^= 1
            if self.device.type == "cuda":
                self._host[slot].copy_(frame, non_blocking=True)
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(self.device))
            else:
                self._host[slot].copy_(frame)
                event = None
            self._inflight.append((frames, slot, event))

    def fetch(self) -> np.ndarray:
        """THE one blocking wait of a tick: the oldest frame in flight
        (frame k-1, or on warm-up frame k) as a host (H, W, 4) u8 array.
        Its device frame is released once its copy has ended (the span
        ``pipe.fetch``)."""
        with tracing.span("pipe.fetch"):
            frames, slot, event = self._inflight[0]
            if event is not None:
                event.synchronize()
            if len(self._inflight) > 1:
                del self._inflight[0]
            return self._host[slot].numpy()


class InteractiveApp:
    def __init__(self, scene_configs: list, width: int, height: int,
                 tk_module=None, *, device="cuda"):
        if tk_module is None:
            import tkinter as tk_module

        self.tk = tk_module
        self.device = torch.device(device)
        self.scene_configs = scene_configs
        self.scene_index = 0
        self.width = width
        self.height = height
        self.keys_down: set = set()
        self.mouse_down = False
        self.last_mouse = (0, 0)
        self.running = True

        self.root = self.tk.Tk()
        self.root.title("compute-renderer-tpu")
        self.canvas = self.tk.Canvas(self.root, width=width, height=height,
                                     highlightthickness=0)
        self.canvas.pack()
        self.photo = None

        self.root.bind("<KeyPress>", self._on_key_press)
        self.root.bind("<KeyRelease>", self._on_key_release)
        self.root.bind("<Configure>", self._on_resize)
        self.canvas.bind("<ButtonPress-1>", self._on_mouse_down)
        self.canvas.bind("<ButtonRelease-1>", self._on_mouse_up)
        self.canvas.bind("<Motion>", self._on_mouse_move)

        # Pipelined-present state: the frame dispatched last tick, fetched
        # and blitted this tick.
        self._pipe = FramePipe(self.device)
        self._tick_count = 0
        self._fps = 0.0
        self._hud = None

        self._load_scene(0)
        self.last_frame = time.perf_counter()

    # -- scene management (window.rs:274-342) --------------------------------

    def _load_scene(self, index: int) -> None:
        self._pipe.reset()  # old renderer's frame: drop, don't blit
        self.scene_index = index % len(self.scene_configs)
        config = self.scene_configs[self.scene_index]
        self.scene = Scene.from_config(config, self.width, self.height)
        self.renderer = Renderer(self.scene.mesh, self.width, self.height,
                                 backend=config.normalized_backend(),
                                 device=self.device,
                                 **self.scene.renderer_options())
        # Fresh collector per scene (window.rs:295-300); duration None means
        # endless interactive use (scene.rs:232 u64::MAX default).
        self.collector = PerformanceCollector(
            config.scene_name(), self.scene_index,
            config.benchmark_duration_secs,
            num_triangles=self.scene.mesh.num_triangles,
            num_pixels=self.width * self.height,
        )

    def _next_scene_or_exit(self) -> None:
        """Benchmark-end handling (window.rs:203-209, 274-281): finalise the
        collector; advance to the next config, or exit after the last one."""
        self.collector.finalise()
        if self.scene_index + 1 >= len(self.scene_configs):
            self.running = False
            self.root.destroy()
            return
        self._load_scene(self.scene_index + 1)

    # -- input ----------------------------------------------------------------

    def _on_key_press(self, event) -> None:
        name = event.keysym.lower()
        if name == "escape":
            self._load_scene(self.scene_index + 1)
            return
        if name in _KEYMAP:
            self.keys_down.add(_KEYMAP[name])

    def _on_key_release(self, event) -> None:
        name = event.keysym.lower()
        if name in _KEYMAP:
            self.keys_down.discard(_KEYMAP[name])

    def _on_resize(self, event) -> None:
        """Window resize (reference window.rs:137-169): update aspect ratio
        and render at the new framebuffer size."""
        w, h = int(event.width), int(event.height)
        if (w, h) == (self.width, self.height) or w < 16 or h < 16:
            return
        self.width, self.height = w, h
        self._pipe.reset()  # old framebuffer shape: drop, don't blit
        self.canvas.config(width=w, height=h)
        camera = self.scene.get_active_camera()
        if camera is not None:
            camera.set_aspect_ratio(w / h)
        self.renderer.resize(w, h)

    def _on_mouse_down(self, event) -> None:
        self.mouse_down = True
        self.last_mouse = (event.x, event.y)

    def _on_mouse_up(self, _event) -> None:
        self.mouse_down = False

    def _on_mouse_move(self, event) -> None:
        if not self.mouse_down:
            return
        dx = event.x - self.last_mouse[0]
        dy = self.last_mouse[1] - event.y  # y inverted like mouse-look
        self.last_mouse = (event.x, event.y)
        camera = self.scene.get_active_camera()
        if camera is not None:
            camera.process_mouse(float(dx), float(dy))

    # -- frame loop (window.rs:194-221) ---------------------------------------

    def _fetch(self) -> np.ndarray:
        """THE one blocking device->host wait per frame (the contract
        tests/test_torch_window.py pins). Everything else in the tick —
        uniform upload, frame dispatch, the frame's copy — is
        asynchronous."""
        return self._pipe.fetch()

    def _blit(self, rgba: np.ndarray) -> None:
        """RGBA array -> PPM bytes -> Tk PhotoImage (no deps) + FPS HUD."""
        header = f"P6 {self.width} {self.height} 255 ".encode()
        self.photo = self.tk.PhotoImage(
            data=header + rgba[:, :, :3].tobytes(), format="PPM"
        )
        self.canvas.create_image(0, 0, image=self.photo, anchor="nw")
        hud_text = f"{self._fps:5.1f} fps"
        if self._hud is None:
            self._hud = self.canvas.create_text(
                6, 6, text=hud_text, anchor="nw", fill="#ffffff",
                font=("TkFixedFont", 10),
            )
        else:
            self.canvas.itemconfigure(self._hud, text=hud_text)
        self.canvas.tag_raise(self._hud)

    def _tick(self) -> None:
        if not self.running:
            return
        now = time.perf_counter()
        dt = now - self.last_frame
        self.last_frame = now
        if dt > 0:
            # EMA of the measured rate for the HUD.
            self._fps = 0.9 * self._fps + 0.1 / dt

        camera = self.scene.get_active_camera()
        if camera is not None:
            camera.update_over_time(dt)
            camera.process_keyboard(self.keys_down, dt)
        uniforms = self.scene.update(dt)

        self._tick_count += 1
        if (self._tick_count % FLUSH_INTERVAL == 0
                and self.renderer.flush_overflow()):
            # A recent unchecked frame dropped triangles (binning capacity):
            # one checked render grows the capacities from the reported
            # need, presents correctly, and the pipeline restarts.
            self._pipe.reset()
            self._blit(self.renderer.render(uniforms))
        else:
            # Pipelined present: dispatch frame k and enqueue its copy
            # BEFORE waiting for frame k-1's, so the card renders k while
            # k-1 is blitted. On warm-up (first frame after scene load /
            # resize) the just-dispatched frame is presented directly —
            # still exactly one blocking wait.
            self._pipe.push(self.renderer.render_batch_device(
                [uniforms], check=False))
            self._blit(self._fetch())

        # Scene-done check (reference window.rs:203-209): update() returns
        # True once the benchmark duration + warm-up has elapsed.
        if self.collector.update():
            self._next_scene_or_exit()
            if not self.running:
                return
        self.root.after(1, self._tick)

    def run(self) -> None:
        self.root.after(1, self._tick)
        self.root.mainloop()


def run_interactive(config: SceneConfig, width: int, height: int,
                    device="cuda") -> None:
    # Probe ONLY the windowing system: scene-load or renderer errors inside
    # InteractiveApp must surface as themselves, not be relabeled "no
    # display" (which would also make the CLI retry the same failure
    # headlessly).
    try:
        import tkinter as tk

        probe = tk.Tk()
        probe.destroy()
    except Exception as e:  # no display / no tkinter
        raise RuntimeError(
            "Interactive viewer unavailable (no display?). "
            "Use headless mode instead."
        ) from e
    app = InteractiveApp([config], width, height, device=device)
    app.run()
