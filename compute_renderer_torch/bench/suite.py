"""The benchmark suite (reference src/main.rs:150-232, 8 scenes; +13
extension rows): a copy of the JAX package's ``bench/suite.py``.

6 models x {custom (the port's ``cuda`` engine), baseline (xla)}
backends, then the 4 reference scenes on wgpu-faithful and the 5
structured-scene rows: 21 rows, 30 s each, fixed first-person camera
spawns. Camera spawn positions match the reference exactly; the models
resolve to procedural stand-ins unless the real OBJ assets are present
(they are Git-LFS files not shipped with the source). Every row renders
on ``device`` ("cuda", the default, raises without a card; "cpu" runs
the torch twins).
"""

from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np

import torch

from compute_renderer_torch.core.camera import CameraMode
from compute_renderer_torch.engine.renderer import Renderer
from compute_renderer_torch.engine.scene import CameraConfig, Scene, SceneConfig
from compute_renderer_torch.bench.collector import PerformanceCollector


def benchmark_scene_configs(duration_secs: float = 30.0) -> list:
    """Reference main.rs:150-232: San Miguel, Exterior, Suzanne, Vokselia,
    each as custom (cuda) then baseline (xla); then the extension rows."""

    def fp(position):
        return CameraConfig(mode=CameraMode.FIRST_PERSON, position=tuple(position))

    san_miguel = SceneConfig(
        model_path="San_Miguel/san-miguel-low-poly.obj",
        camera_config=fp([13.566635, 2.6288567, 10.243919]),
        benchmark_duration_secs=duration_secs,
    )
    exterior = SceneConfig(
        model_path="exterior/Exterior.obj",
        camera_config=fp([-525.80194, 168.52838, 260.81876]),
        benchmark_duration_secs=duration_secs,
    )
    suzanne = SceneConfig(
        model_path="suzanne.obj",
        camera_config=CameraConfig(
            distance=2.0, mode=CameraMode.FIRST_PERSON, position=(0.0, 0.0, 3.0)
        ),
        benchmark_duration_secs=duration_secs,
    )
    vokselia = SceneConfig(
        model_path="vokselia_spawn/vokselia_spawn.obj",
        camera_config=fp([0.0, 0.86896104, 1.4793645]),
        benchmark_duration_secs=duration_secs,
    )
    # Extension rows beyond the reference's 8: the round-1 small stand-ins
    # kept for continuity (the main San Miguel / Vokselia rows now match the
    # reference's real triangle classes, ~1M / ~800k — io/procedural.py).
    san_miguel_small = SceneConfig(
        model_path="san_miguel_small.obj",
        camera_config=fp([13.566635, 2.6288567, 10.243919]),
        benchmark_duration_secs=duration_secs,
    )
    vokselia_small = SceneConfig(
        model_path="vokselia_spawn_small.obj",
        camera_config=fp([0.0, 0.86896104, 1.4793645]),
        benchmark_duration_secs=duration_secs,
    )

    import dataclasses

    scenes = []
    for base in (san_miguel, exterior, suzanne, vokselia,
                 san_miguel_small, vokselia_small):
        scenes.append(base)
        scenes.append(dataclasses.replace(base, backend_type="xla"))
    # Hardware-pipeline rows (VERDICT r4 next #6): the reference's headline
    # benchmark is every scene on BOTH its pipelines — the custom compute
    # rasterizer AND the plain wgpu hardware pipeline (main.rs:150-232,
    # wgpu_pipeline/renderer.rs:290-393). The cuda rows above are the custom
    # pipeline's analog; these rows are the hardware pipeline's
    # (backends/wgpu_faithful.py: near-plane clipping, top-left rule,
    # perspective-correct interpolation, sRGB — the reference's visual
    # baseline). Like the reference's wgpu path they fence every frame
    # (wait_for_gpu, renderer.rs:383-393) — batch 1 in run_suite.
    for base in (san_miguel, exterior, suzanne, vokselia):
        scenes.append(dataclasses.replace(base,
                                          backend_type="wgpu-faithful"))
    # Structurally-real file row (VERDICT r2 #7): a synthesized ~1M-tri
    # multi-submesh OBJ loaded from DISK through Model.load -> native C++
    # parser -> renderer, so the suite exercises parse + dedup + concat +
    # render end-to-end (the other mega rows inject procedural Meshes).
    # Engine only: the xla brute-force comparator at this scale is
    # already covered by the San Miguel xla row. The
    # asset itself is synthesized lazily at LOAD time (Model.load) —
    # enumerating configs must not write 80 MB to disk.
    from compute_renderer_torch.io.objgen import STRUCTURED_NAME

    scenes.append(SceneConfig(
        model_path=STRUCTURED_NAME,
        camera_config=fp([13.566635, 4.0, 24.0]),
        benchmark_duration_secs=duration_secs,
    ))
    # Material-extension row: the SAME structured scene with its companion
    # MTL resolved into per-triangle diffuse, rendered on the micro path's
    # material mode — measures the extension's cost against the
    # row above (identical geometry/camera; only kd plumbing differs).
    scenes.append(SceneConfig(
        model_path=STRUCTURED_NAME,
        camera_config=fp([13.566635, 4.0, 24.0]),
        benchmark_duration_secs=duration_secs,
        enable_materials=True,
    ))
    # Texture-extension row: a smaller (~36k tri, single-chunk tile path)
    # build of the structured scene whose MTL carries generated map_Kd
    # images — parse -> image decode -> atlas -> raster -> texture tail,
    # end-to-end from disk.
    from compute_renderer_torch.io.objgen import STRUCTURED_TEX_NAME

    scenes.append(SceneConfig(
        model_path=STRUCTURED_TEX_NAME,
        camera_config=fp([13.566635, 4.0, 24.0]),
        benchmark_duration_secs=duration_secs,
        enable_textures=True,
    ))
    # Mega-texture row: the ~1M-tri structured scene with its map_Kd
    # images — the micro (mega-scene) path's texture mode at scale.
    # Compare against the plain and materials rows above (identical
    # geometry/camera) for the extension's cost.
    scenes.append(SceneConfig(
        model_path=STRUCTURED_NAME,
        camera_config=fp([13.566635, 4.0, 24.0]),
        benchmark_duration_secs=duration_secs,
        enable_textures=True,
    ))
    # Quality-extension row: the textured small scene again with bilinear
    # filtering AND 2x SSAA — the full quality stack (4x pixels + 4-texel
    # lerps) against row "structured_tex" above for the extensions' cost.
    scenes.append(SceneConfig(
        model_path=STRUCTURED_TEX_NAME,
        camera_config=fp([13.566635, 4.0, 24.0]),
        benchmark_duration_secs=duration_secs,
        enable_textures=True,
        texture_filter="bilinear",
        ssaa=2,
    ))
    return scenes


def run_scene(config: SceneConfig, width: int, height: int, scene_index: int = 0,
              warmup_secs: Optional[float] = None,
              max_frames: Optional[int] = None, batch: int = 1,
              device="cuda") -> dict:
    """Run one benchmark scene to completion; returns the metrics dict.

    The frame loop mirrors the reference's (window.rs:345-410): camera
    update -> scene update -> render -> collector. ``batch=1`` fences every
    frame (true per-frame latency, including any host<->device link
    latency); ``batch>1`` renders that many frames per dispatch and fences
    per batch — the throughput measurement matching the reference custom
    backend's async submits (custom_pipeline/renderer.rs:152-156). The
    first batch is rendered checked (overflow read, capacities settled,
    the micro path calibrated); later batches leave their overflow flags
    on the device until ``flush_overflow`` at the end, whose result is
    the row's ``overflow``."""
    scene = Scene.from_config(config, width, height)
    renderer = Renderer(scene.mesh, width, height,
                        backend=config.normalized_backend(), device=device,
                        **scene.renderer_options())
    if max_frames is not None and warmup_secs is None:
        # Smoke mode: a frame cap shorter than the 2 s warm-up would record
        # nothing; skip the warm-up so capped runs still produce metrics.
        warmup_secs = 0.0
    collector = PerformanceCollector(
        config.scene_name(), scene_index, config.benchmark_duration_secs,
        num_triangles=scene.total_tris, num_pixels=width * height,
        warmup_secs=warmup_secs,
    )

    frames = 0
    last = time.perf_counter()
    while True:
        now = time.perf_counter()
        dt = now - last
        last = now

        camera = scene.get_active_camera()
        if camera is not None:
            camera.update_over_time(dt)

        if batch <= 1:
            uniforms = scene.update(dt)
            renderer.render_blocked(uniforms)
            frames += 1
            done = collector.update()
        else:
            # dt spans the whole previous batch; each frame advances its
            # share so animation speed matches the unbatched loop.
            per_dt = dt / batch
            uniforms_seq = [scene.update(per_dt) for _ in range(batch)]
            t0 = time.perf_counter()
            # First batch checks (and retries) binning overflow so the
            # capacities settle; steady-state batches accumulate the flags
            # on-device (no per-batch round trip) and flush at scene end.
            out = renderer.render_batch_device(uniforms_seq, check=(frames == 0))
            # The checked first batch has read its flags; the others wait
            # for the device.
            if frames == 0:
                out[-1, 0, 0].cpu()
            else:
                renderer.fence_pending()
            elapsed = time.perf_counter() - t0
            frames += batch
            done = collector.update_batch(batch, elapsed)

        if done or (
            max_frames is not None
            and len(collector.frame_times) >= max_frames
        ):
            break

    overflowed = renderer.flush_overflow()
    # The next row's renderer must not share the card with this one's
    # captured graphs.
    renderer.close()
    if overflowed:
        print(f"WARNING: {config.scene_name()}: binning overflow occurred "
              "after the first batch; some frames dropped triangles")
    data = collector.finalise()
    result = json.loads(data.to_json())
    result["overflow"] = overflowed
    result["scene"] = config.scene_name()
    result["backend"] = config.normalized_backend()
    result["num_triangles"] = scene.total_tris
    result["width"] = width
    result["height"] = height
    return result


def measure_dispatch_overhead_ms(samples: int = 12, device="cuda") -> float:
    """Median round-trip of a trivial device op + 1-element fetch — the
    fixed per-dispatch cost of the host<->device link. Reported alongside
    every suite row so batched numbers can be read as engine time +
    overhead/batch with one methodology."""
    x = torch.zeros((8,), dtype=torch.float32, device=device)
    (x + 1)[0].item()  # warm
    times = []
    for _ in range(samples):
        t0 = time.perf_counter()
        (x + 1)[0].item()
        times.append((time.perf_counter() - t0) * 1000)
    return float(np.median(times))


def run_suite(width: int = 1024, height: int = 768, offset: int = 0,
              duration_secs: float = 30.0, json_path: Optional[str] = None,
              max_frames: Optional[int] = None, batch: int = 1,
              limit: Optional[int] = None, device="cuda") -> list:
    """Run the full suite starting at scene ``offset`` (reference
    `benchmarks --offset N`); ``limit`` caps the number of scenes run
    (extension — the reference always runs to the end). ``device="cuda"``
    (the default) raises without a card."""
    scenes = benchmark_scene_configs(duration_secs)
    if not 0 <= offset < len(scenes):
        raise ValueError(
            f"Invalid offset: {offset}. There are only {len(scenes)} scenes."
        )
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the suite runs on the card (device='cuda') and "
                           "torch.cuda.is_available() is False; pass "
                           "device='cpu' for the torch twins")
    overhead_ms = measure_dispatch_overhead_ms(device=device)
    results = []
    end = len(scenes) if limit is None else min(offset + limit, len(scenes))
    for i in range(offset, end):
        # Batched dispatch amortizes the fixed per-dispatch cost — it
        # matters when engine frames are sub-millisecond (the cuda
        # backend, whose batches replay one CUDA graph a frame). The
        # comparators run eagerly, frame by frame, at far more than the
        # dispatch cost a frame: batching those would only multiply
        # wall-clock.
        row_batch = batch if scenes[i].normalized_backend() == "cuda" else 1
        r = run_scene(scenes[i], width, height, scene_index=i,
                      max_frames=max_frames, batch=row_batch, device=device)
        r["batch"] = row_batch
        r["dispatch_overhead_ms"] = overhead_ms
        r["dispatch_overhead_ms_per_frame"] = overhead_ms / max(row_batch, 1)
        results.append(r)
    if json_path:
        with open(json_path, "w") as f:
            json.dump(results, f, indent=2)
    return results
