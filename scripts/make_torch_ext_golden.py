#!/usr/bin/env python
"""Write tests/golden_data/torch_ext_structured_1024x768.npz.

Renders the material and texture rows of the reference's benchmark suite
(bench/suite.py:101-144) at 1024x768 with the JAX package on the CPU,
Pallas kernels in interpret mode, first-person camera at
(13.566635, 4.0, 24.0), default lights, dt = 1/60:

- ``materials``: structured_scene.obj (1,023,442 triangles, micro path)
  with its MTL's Kd rows — three frames;
- ``textures``: the same scene with its map_Kd images, nearest filter —
  three frames;
- ``tex_textures``: structured_scene_tex.obj (36,322 triangles, tile
  path) with textures, nearest — three frames;
- ``tex_bilinear_ssaa2``: the same with bilinear filtering and 2x SSAA —
  one frame;
- ``tex_materials``: structured_scene_tex.obj with its Kd rows only (the
  tile path's material mode, which no suite row takes) — three frames.

Each array is (frames, 768, 1024, 4) uint8. The scenes are synthesized
into the gitignored ``assets/`` on first use (io/objgen.py). The texture
rows take the fused-texture mode (the G-buffer kernels and
``common.fused_texture_tail``), as the JAX engine does for these atlases.
``chip_smoke.py`` and tests/test_torch_ext.py hold the PyTorch port's
frames against this file, since the machine with the card has no JAX.

The engine's ``Renderer`` is not used: it bakes the geometry into the
compiled step as constants, which at a million triangles costs far more
compile time and memory than the frames.

Run from the repository root (a few minutes):

    JAX_PLATFORMS=cpu python scripts/make_torch_ext_golden.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from compute_renderer_tpu.backends import common, tpu  # noqa: E402
from compute_renderer_tpu.core.camera import CameraMode  # noqa: E402
from compute_renderer_tpu.engine.renderer import box_downsample  # noqa: E402
from compute_renderer_tpu.engine.scene import (  # noqa: E402
    CameraConfig,
    Scene,
    SceneConfig,
)
from compute_renderer_tpu.io.objgen import (  # noqa: E402
    STRUCTURED_NAME,
    STRUCTURED_TEX_NAME,
)

WIDTH, HEIGHT, DT = 1024, 768, 1.0 / 60.0
CAMERA = (13.566635, 4.0, 24.0)
OUT = os.path.join(ROOT, "tests", "golden_data",
                   "torch_ext_structured_1024x768.npz")
# row name -> (model, SceneConfig extension options, frames)
ROWS = {
    "materials": (STRUCTURED_NAME, {"enable_materials": True}, 3),
    "textures": (STRUCTURED_NAME, {"enable_textures": True}, 3),
    "tex_textures": (STRUCTURED_TEX_NAME, {"enable_textures": True}, 3),
    "tex_bilinear_ssaa2": (STRUCTURED_TEX_NAME,
                           {"enable_textures": True,
                            "texture_filter": "bilinear", "ssaa": 2}, 1),
    "tex_materials": (STRUCTURED_TEX_NAME, {"enable_materials": True}, 3),
}


def render_row(model, options, frames):
    config = SceneConfig(
        model_path=model,
        camera_config=CameraConfig(mode=CameraMode.FIRST_PERSON,
                                   position=CAMERA),
        **options,
    )
    scene = Scene.from_config(config, WIDTH, HEIGHT)
    mesh = scene.mesh
    ssaa = config.ssaa
    width, height = WIDTH * ssaa, HEIGHT * ssaa
    T = mesh.num_triangles
    path = tpu.resolve_path("auto", T)
    pos = jnp.asarray(mesh.positions)
    nrm = jnp.asarray(mesh.normals)
    uvs = jnp.asarray(mesh.uvs)
    tri = jnp.asarray(mesh.indices.astype(np.int32)).reshape(-1, 3)
    kw = {"face_kd": jnp.asarray(mesh.face_kd)}
    if mesh.has_textures:
        assert tpu.texf_eligible(mesh.tex_table)
        kw.update(face_tex=jnp.asarray(mesh.face_tex),
                  texels=jnp.asarray(mesh.texels),
                  tex_table=jnp.asarray(mesh.tex_table),
                  tex_filter=config.texture_filter,
                  uv_soa=uvs[tri].transpose(1, 2, 0),
                  tex_rows=common.tex_rows_f32(jnp.asarray(mesh.face_tex),
                                               jnp.asarray(mesh.tex_table)))
    if path == "micro":
        kw.update(pos_soa=pos[tri].transpose(1, 2, 0),
                  nrm_soa=nrm[tri].transpose(1, 2, 0))
    caps = tpu.default_caps(path, T, width, height)
    pair_cap = 0 if path == "micro" else caps["pair_cap"]
    tile_cap = caps["tile_cap"] or 0
    out = []
    for _ in range(frames):
        u = scene.update(DT)
        while True:
            rgba, _, overflow = tpu.render_frame(
                pos, nrm, uvs, tri, jnp.asarray(u.view_proj),
                jnp.asarray(u.view_position),
                jnp.asarray(u.light_world_pos), jnp.asarray(u.light_color),
                jnp.asarray(u.light_intensity), jnp.asarray(u.effect),
                width=width, height=height, pair_cap=pair_cap,
                tile_cap=tile_cap, path=path, interpret=True, **kw)
            need = np.asarray(overflow)
            if not need.any():
                break
            if need[0]:
                pair_cap = tpu.grow_pair_cap(pair_cap, int(need[0]))
            if need[1]:
                tile_cap = tpu.grow_tile_cap(tile_cap, int(need[1]),
                                             caps["tile_h"], caps["tile_w"])
        if ssaa > 1:
            rgba = box_downsample(rgba, ssaa)
        out.append(np.asarray(rgba))
    out = np.stack(out)
    covered = int((out[0] != np.array([0, 0, 255, 255], np.uint8))
                  .any(axis=-1).sum())
    print(f"{model} {options}: T={T}, path {path}, {out.shape}, {covered} "
          "covered pixels in frame 0", flush=True)
    return out, T


def main() -> int:
    arrays, counts = {}, {}
    for name, (model, options, frames) in ROWS.items():
        arrays[name], counts[name] = render_row(model, options, frames)
    np.savez_compressed(OUT, triangles=np.array(
        [counts[name] for name in ROWS], np.int64), **arrays)
    print(f"wrote {OUT}: rows {list(ROWS)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
