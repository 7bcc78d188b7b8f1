"""Headless frame loop: render N frames, write PNGs.

The structural equivalent of the reference's per-frame update loop
(window.rs:345-410) without the OS window: dt -> camera update -> scene
update -> render -> 'present' (PNG write). A copy of the JAX package's
``app/headless.py``; the renderer runs on ``device`` ("cuda", the
default, raises without a card; "cpu" runs the torch twins).
"""

from __future__ import annotations

import time
from pathlib import Path

from compute_renderer_torch.engine.renderer import Renderer
from compute_renderer_torch.engine.scene import Scene, SceneConfig


def write_png(path, rgba) -> None:
    """Write an (H, W, 4) uint8 array as PNG with the minimal zlib writer,
    whether or not Pillow is installed (the JAX package's takes Pillow
    when it can): the same bytes on every machine, and none needs
    Pillow."""
    Path(path).write_bytes(encode_png(rgba))


def encode_png(rgba, level: int = 6) -> bytes:
    """An RGBA PNG from the standard library alone: one IDAT of the rows,
    each with filter byte 0, compressed by zlib at ``level`` (6 for
    files; the web viewer re-encodes every frame and takes 1, rate over
    ratio)."""
    import struct
    import zlib

    h, w = rgba.shape[:2]
    raw = b"".join(b"\x00" + rgba[i].tobytes() for i in range(h))

    def chunk(tag, data):
        c = struct.pack(">I", len(data)) + tag + data
        return c + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    ihdr = struct.pack(">IIBBBBB", w, h, 8, 6, 0, 0, 0)
    return (
        b"\x89PNG\r\n\x1a\n"
        + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw, level))
        + chunk(b"IEND", b"")
    )


def run_headless(config: SceneConfig, width: int, height: int,
                 frames: int = 1, output: str = "frame.png",
                 dt: float | None = None, device="cuda") -> list:
    """Render ``frames`` frames; returns the list of written paths.

    ``dt`` fixes the per-frame timestep (deterministic animation); None uses
    wall-clock like the reference's interactive loop.

    ``output`` ending in ``.gif`` with ``frames > 1`` writes ONE animated
    GIF (extension past the reference, which never records; requires
    Pillow) instead of numbered PNGs."""
    out = Path(output)
    as_gif = out.suffix.lower() == ".gif" and frames > 1
    if as_gif:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                "animated GIF output requires Pillow; use a .png output "
                "for numbered frames instead"
            ) from e
    scene = Scene.from_config(config, width, height)
    renderer = Renderer(scene.mesh, width, height,
                        backend=config.normalized_backend(), device=device,
                        **scene.renderer_options())

    written = []
    gif_frames = []
    last = time.perf_counter()
    for i in range(frames):
        if dt is None:
            now = time.perf_counter()
            step = now - last
            last = now
        else:
            step = dt
        camera = scene.get_active_camera()
        if camera is not None:
            camera.update_over_time(step)
        uniforms = scene.update(step)
        rgba = renderer.render(uniforms)

        if as_gif:
            gif_frames.append(Image.fromarray(rgba[..., :3]))
            continue
        if frames == 1:
            path = out
        else:
            path = out.with_name(f"{out.stem}_{i:04d}{out.suffix}")
        write_png(path, rgba)
        written.append(path)
    if as_gif:
        ms = int(round((dt if dt is not None else 1 / 30) * 1000))
        gif_frames[0].save(
            str(out), save_all=True, append_images=gif_frames[1:],
            duration=max(ms, 10), loop=0,
        )
        written.append(out)
    return written
