#!/usr/bin/env python
"""Write tests/golden_data/torch_comparators_1024x768.npz.

Renders the comparator rows of the reference's benchmark suite
(bench/suite.py:23-145) at 1024x768 with the JAX package on the CPU,
default lights, one frame at dt = 1/60, each scene at its suite camera:

- ``suzanne_xla`` / ``suzanne_wgpu``: suzanne.obj (the procedural
  stand-in, 1,280 triangles), first-person camera at (0, 0, 3), through
  ``backends/xla.py`` and ``backends/wgpu_faithful.py``;
- ``exterior_xla`` / ``exterior_wgpu``: exterior/Exterior.obj (16,384
  triangles), first-person camera at (-525.80194, 168.52838, 260.81876);
- ``structured_tex_xla``: structured_scene_tex.obj (36,322 triangles,
  synthesized into the gitignored ``assets/`` on first use) with its
  map_Kd textures, nearest filter, first-person camera at
  (13.566635, 4.0, 24.0), through ``backends/xla.py``.

Each ``<row>`` is a (768, 1024, 4) uint8 frame; each xla row also has
``<row>_tri``, the (768, 1024) int32 winner ids (-1 uncovered). The
comparators' ``chunk`` is 32 triangles a step (their frames do not depend
on it). ``chip_smoke.py`` and tests/test_torch_comparators.py hold the
PyTorch port's comparator frames against this file, since the machine
with the card has no JAX.

Run from the repository root:

    JAX_PLATFORMS=cpu python scripts/make_torch_comparators_golden.py

It ran in 265 s on 8 CPU cores (the first run adds the synthesis of
structured_scene_tex.obj, a few seconds).
"""

import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from compute_renderer_tpu.backends import wgpu_faithful, xla  # noqa: E402
from compute_renderer_tpu.core.camera import CameraMode  # noqa: E402
from compute_renderer_tpu.engine.scene import (  # noqa: E402
    CameraConfig,
    Scene,
    SceneConfig,
)
from compute_renderer_tpu.io.objgen import STRUCTURED_TEX_NAME  # noqa: E402

WIDTH, HEIGHT, DT, CHUNK = 1024, 768, 1.0 / 60.0, 32
OUT = os.path.join(ROOT, "tests", "golden_data",
                   "torch_comparators_1024x768.npz")
SUZANNE = ("suzanne.obj", CameraConfig(distance=2.0,
                                       mode=CameraMode.FIRST_PERSON,
                                       position=(0.0, 0.0, 3.0)), {})
EXTERIOR = ("exterior/Exterior.obj",
            CameraConfig(mode=CameraMode.FIRST_PERSON,
                         position=(-525.80194, 168.52838, 260.81876)), {})
STRUCTURED_TEX = (STRUCTURED_TEX_NAME,
                  CameraConfig(mode=CameraMode.FIRST_PERSON,
                               position=(13.566635, 4.0, 24.0)),
                  {"enable_textures": True})
# row name -> (scene, backend)
ROWS = {
    "suzanne_xla": (SUZANNE, "xla"),
    "suzanne_wgpu": (SUZANNE, "wgpu-faithful"),
    "exterior_xla": (EXTERIOR, "xla"),
    "exterior_wgpu": (EXTERIOR, "wgpu-faithful"),
    "structured_tex_xla": (STRUCTURED_TEX, "xla"),
}


def render_row(scene_spec, backend):
    model, camera, options = scene_spec
    config = SceneConfig(model_path=model, camera_config=camera, **options)
    scene = Scene.from_config(config, WIDTH, HEIGHT)
    mesh = scene.mesh
    u = scene.update(DT)
    args = (
        jnp.asarray(mesh.positions), jnp.asarray(mesh.normals),
        jnp.asarray(mesh.uvs),
        jnp.asarray(mesh.indices.astype(np.int32)).reshape(-1, 3),
        jnp.asarray(u.view_proj), jnp.asarray(u.view_position),
        jnp.asarray(u.light_world_pos), jnp.asarray(u.light_color),
        jnp.asarray(u.light_intensity), jnp.asarray(u.effect),
    )
    if backend == "wgpu-faithful":
        rgba, _ = wgpu_faithful.render_frame(*args, width=WIDTH,
                                             height=HEIGHT, chunk=CHUNK)
        return {"": np.asarray(rgba)}, mesh.num_triangles
    kw = {}
    if mesh.has_textures:
        kw = {"face_kd": jnp.asarray(mesh.face_kd),
              "face_tex": jnp.asarray(mesh.face_tex),
              "texels": jnp.asarray(mesh.texels),
              "tex_table": jnp.asarray(mesh.tex_table),
              "tex_filter": "nearest"}
    rgba, _, best_tri = xla.render_frame(*args, width=WIDTH, height=HEIGHT,
                                         chunk=CHUNK, return_tri=True, **kw)
    return ({"": np.asarray(rgba), "_tri": np.asarray(best_tri)},
            mesh.num_triangles)


def main() -> int:
    arrays = {}
    t_all = time.perf_counter()
    for name, (spec, backend) in ROWS.items():
        t0 = time.perf_counter()
        out, T = render_row(spec, backend)
        for suffix, a in out.items():
            arrays[name + suffix] = a
        covered = int((out[""] != np.array([0, 0, 255, 255], np.uint8))
                      .any(axis=-1).sum())
        print(f"{name}: T={T}, {covered} covered pixels, "
              f"{time.perf_counter() - t0:.1f} s", flush=True)
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes) in "
          f"{time.perf_counter() - t_all:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
