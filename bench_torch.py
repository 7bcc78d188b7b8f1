#!/usr/bin/env python3
"""bench.py's measurement of the PyTorch port, on one NVIDIA GPU.

    python3 bench_torch.py

Renders bench.py's configuration (bench.py:201-275): the 1024x768
Suzanne scene, first-person camera at (0, 0, 3), the default lights,
through ``compute_renderer_torch.Renderer(device="cuda")``. Both batch
sizes are rendered once to warm up (the first frames also capture the
frame's CUDA graph and tune the tile shape); then animated batches of 64
and 256 frames go through ``render_batch_device``, every frame a replayed
graph, each batch ending in ``fence_pending()``, best of 4 rounds each.
The headline is bench.py's batch slope, (t256 - t64) / 192, with its
guard: never above the wall ms/frame at 256, and the wall number where
the slope is not positive. Prints bench.py's one JSON line; its ``extra``
holds the card's name and power limit (as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives them), the
kernels and host calls a frame (torch.profiler) and the tile shape the
renderer picked. Without a CUDA card it says so and exits 1.
"""

import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
WIDTH, HEIGHT = 1024, 768
BATCH_SMALL, BATCH_LARGE, ROUNDS = 64, 256, 4  # bench.py's
TARGET_MS = 1.0  # bench.py's north star: a frame in under 1 ms
DT = 1.0 / 60.0


def slope_result(best_small: float, best_large: float, batch_small: int,
                 batch_large: int) -> dict:
    """bench.py's numbers from the best seconds of each batch size: the
    slope (ms/frame), the wall ms/frame of each size, and the headline —
    the slope, but never above the large batch's wall ms/frame, and that
    wall number where the slope is not positive (noise hit the small
    batches harder: not a measurement)."""
    slope_ms = (best_large - best_small) / (batch_large - batch_small) * 1e3
    wall_ms = best_large / batch_large * 1e3
    slope_valid = slope_ms > 0.0
    return {
        "ms_per_frame": min(slope_ms, wall_ms) if slope_valid else wall_ms,
        "slope_ms": slope_ms,
        "slope_valid": slope_valid,
        "wall_ms_large": wall_ms,
        "wall_ms_small": best_small / batch_small * 1e3,
    }


def time_batches(renderer, make_batch, batch_small: int, batch_large: int,
                 rounds: int, clock=time.perf_counter) -> tuple:
    """(best seconds at batch_small, at batch_large): a checked warm-up
    batch of each size, then ``rounds`` unchecked, fenced batches of each;
    raises if any frame overflowed its binning capacity."""
    renderer.render_batch_device(make_batch(batch_small))
    renderer.render_batch_device(make_batch(batch_large))
    renderer.fence_pending()

    def timed_round(n):
        batch = make_batch(n)
        t0 = clock()
        renderer.render_batch_device(batch, check=False)
        renderer.fence_pending()
        return clock() - t0

    best_small = min(timed_round(batch_small) for _ in range(rounds))
    best_large = min(timed_round(batch_large) for _ in range(rounds))
    if renderer.flush_overflow():
        raise RuntimeError("binning overflow during the timed batches")
    return best_small, best_large


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("bench_torch: torch.cuda.is_available() is False — this "
              "benchmark needs an NVIDIA GPU", file=sys.stderr)
        return 1

    from compute_renderer_torch import (
        CameraConfig, Renderer, Scene, SceneConfig,
    )
    from compute_renderer_torch.bench import profiling
    from compute_renderer_torch.core.camera import CameraMode

    config = SceneConfig(
        model_path="suzanne.obj",
        camera_config=CameraConfig(distance=2.0, mode=CameraMode.FIRST_PERSON,
                                   position=(0.0, 0.0, 3.0)))
    scene = Scene.from_config(config, WIDTH, HEIGHT)
    renderer = Renderer(scene.mesh, WIDTH, HEIGHT, device="cuda",
                        **scene.renderer_options())

    def make_batch(n):
        # Animated uniforms, updated every frame as the reference's loop
        # does (scene.rs:132-188).
        return [scene.update(DT) for _ in range(n)]

    best_small, best_large = time_batches(renderer, make_batch, BATCH_SMALL,
                                          BATCH_LARGE, ROUNDS)
    res = slope_result(best_small, best_large, BATCH_SMALL, BATCH_LARGE)
    profile = profiling.profile_batch(renderer, make_batch(16), {})
    host_calls = profiling.host_calls_per_frame(renderer, make_batch)
    if renderer.flush_overflow():
        raise RuntimeError("binning overflow in the profiled batches")
    ms = res["ms_per_frame"]
    print(json.dumps({
        "metric": "ms/frame 1024x768 suzanne-class (cuda backend, "
                  "batch-slope engine time)",
        "value": round(ms, 4),
        "unit": "ms",
        "vs_baseline": round(TARGET_MS / ms, 4),
        "extra": {
            "backend": "cuda",
            "device": torch.cuda.get_device_name(0),
            "card": profiling.card_line(),
            "methodology": "slope of best-of-%d wall time over batch sizes "
                           "%d and %d (every frame a replayed CUDA graph; "
                           "intercept = per-batch host work)"
                           % (ROUNDS, BATCH_SMALL, BATCH_LARGE),
            "slope_valid": res["slope_valid"],
            "slope_ms_per_frame": round(res["slope_ms"], 4),
            f"wall_ms_per_frame_batch{BATCH_LARGE}": round(
                res["wall_ms_large"], 4),
            f"wall_ms_per_frame_batch{BATCH_SMALL}": round(
                res["wall_ms_small"], 4),
            "kernels_per_frame": profile["kernels"],
            "device_busy_ms_per_frame": round(profile["busy_ms"], 6),
            "host_calls_per_frame": host_calls,
            "tile": [renderer.options.get("tile_h"),
                     renderer.options.get("tile_w")],
            "tile_timings_ms": {f"{h}x{w}": round(s * 1e3, 4) for (h, w), s
                                in renderer.tile_timings.items()},
            "num_triangles": scene.total_tris,
            "fps": round(1e3 / ms, 1),
            "mtri_per_s": round(scene.total_tris / (ms / 1e3) / 1e6, 2),
            "mpix_per_s": round(WIDTH * HEIGHT / (ms / 1e3) / 1e6, 1),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
