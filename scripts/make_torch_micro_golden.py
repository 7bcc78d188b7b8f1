#!/usr/bin/env python
"""Write tests/golden_data/torch_micro_san_miguel_1024x768.npz.

Renders the first three frames (dt = 1/60) of the San Miguel benchmark
configuration (bench/suite.py: the 998,784-triangle San Miguel stand-in,
default lights, first-person camera at (13.566635, 2.6288567, 10.243919))
at 1024x768 with the JAX package on the CPU: ``tpu.render_frame_micro``
with the Pallas micro kernel in interpret mode, at the exact pair capacity
the frame needs. The scene resolves to the micro path (it is above
``TILE_PATH_MAX_TRIANGLES``). Stores ``rgba`` (3, 768, 1024, 4) uint8.
``chip_smoke.py`` holds the PyTorch port's frames on the GPU against this
file, since the machine with the card has no JAX.

The engine's ``Renderer`` is not used here: it bakes the geometry into the
compiled step as constants, which at a million triangles costs far more
compile time and memory than the frame itself.

Run from the repository root (about 20 s a frame):

    JAX_PLATFORMS=cpu python scripts/make_torch_micro_golden.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from compute_renderer_tpu.backends import tpu  # noqa: E402
from compute_renderer_tpu.core.camera import CameraMode  # noqa: E402
from compute_renderer_tpu.engine.scene import (  # noqa: E402
    CameraConfig,
    Scene,
    SceneConfig,
)

WIDTH, HEIGHT, FRAMES, DT = 1024, 768, 3, 1.0 / 60.0
MODEL = "San_Miguel/san-miguel-low-poly.obj"
CAMERA = (13.566635, 2.6288567, 10.243919)
OUT = os.path.join(ROOT, "tests", "golden_data",
                   "torch_micro_san_miguel_1024x768.npz")


def main() -> int:
    config = SceneConfig(
        model_path=MODEL,
        camera_config=CameraConfig(mode=CameraMode.FIRST_PERSON,
                                   position=CAMERA),
    )
    scene = Scene.from_config(config, WIDTH, HEIGHT)
    mesh = scene.mesh
    T = mesh.num_triangles
    assert tpu.resolve_path("auto", T) == "micro", T
    pos = jnp.asarray(mesh.positions)
    nrm = jnp.asarray(mesh.normals)
    tri = jnp.asarray(mesh.indices.astype(np.int32)).reshape(-1, 3)
    geometry = dict(pos_soa=pos[tri].transpose(1, 2, 0),
                    nrm_soa=nrm[tri].transpose(1, 2, 0))
    frames = []
    pair_cap = 0
    for _ in range(FRAMES):
        u = scene.update(DT)
        while True:
            rgba, _, overflow = tpu.render_frame_micro(
                pos, nrm, jnp.asarray(mesh.uvs), tri,
                jnp.asarray(u.view_proj), jnp.asarray(u.view_position),
                jnp.asarray(u.light_world_pos), jnp.asarray(u.light_color),
                jnp.asarray(u.light_intensity), jnp.asarray(u.effect),
                width=WIDTH, height=HEIGHT, pair_cap=pair_cap,
                interpret=True, **geometry)
            need = int(np.asarray(overflow)[0])
            if not need:
                break
            pair_cap = tpu.grow_pair_cap(pair_cap, need)
        frames.append(np.asarray(rgba))
    frames = np.stack(frames)
    np.savez_compressed(OUT, rgba=frames)
    covered = int((frames[0] != np.array([0, 0, 255, 255], np.uint8))
                  .any(axis=-1).sum())
    print(f"wrote {OUT}: {frames.shape} {frames.dtype}, T={T}, "
          f"{covered} covered pixels in frame 0")
    return 0


if __name__ == "__main__":
    sys.exit(main())
