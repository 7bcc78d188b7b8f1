#!/usr/bin/env python
"""Write tests/golden_data/torch_slice_suzanne_1024x768.npz.

Renders the first three frames of bench.py's scene (1024x768, the Suzanne
stand-in, default lights, first-person camera at (0, 0, 3), dt = 1/60)
with the JAX package on the CPU (Pallas in interpret mode) and stores them
as ``rgba`` (3, 768, 1024, 4) uint8. ``chip_smoke.py`` holds the PyTorch
port's frames on the GPU against this file, since the machine with the
card has no JAX.

Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/make_torch_slice_golden.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

from compute_renderer_tpu.core.camera import CameraMode  # noqa: E402
from compute_renderer_tpu.engine.renderer import Renderer  # noqa: E402
from compute_renderer_tpu.engine.scene import (  # noqa: E402
    CameraConfig,
    Scene,
    SceneConfig,
)

WIDTH, HEIGHT, FRAMES, DT = 1024, 768, 3, 1.0 / 60.0
OUT = os.path.join(ROOT, "tests", "golden_data",
                   "torch_slice_suzanne_1024x768.npz")


def main() -> int:
    config = SceneConfig(
        model_path="suzanne.obj",
        camera_config=CameraConfig(
            distance=2.0, mode=CameraMode.FIRST_PERSON,
            position=(0.0, 0.0, 3.0)),
        backend_type="tpu",
    )
    scene = Scene.from_config(config, WIDTH, HEIGHT)
    renderer = Renderer(scene.mesh, WIDTH, HEIGHT, backend="tpu",
                        **scene.renderer_options())
    frames = np.stack([renderer.render(scene.update(DT))
                       for _ in range(FRAMES)])
    np.savez_compressed(OUT, rgba=frames)
    covered = int((frames[0] != np.array([0, 0, 255, 255], np.uint8))
                  .any(axis=-1).sum())
    print(f"wrote {OUT}: {frames.shape} {frames.dtype}, "
          f"{covered} covered pixels in frame 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
