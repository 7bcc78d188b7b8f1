#!/usr/bin/env python
"""Write tests/golden_data/torch_mip_structured_1024x768.npz.

Renders the mip-filtered and deferred texture rows of the structured
scenes at 1024x768 with the JAX package on the CPU, Pallas kernels in
interpret mode, first-person camera at (13.566635, 4.0, 24.0), default
lights, dt = 1/60:

- ``tex_trilinear``: structured_scene_tex.obj (36,322 triangles, tile
  path) with textures, trilinear (the TEXF_MIP mode) — three frames;
- ``tex_anisotropic``: the same, anisotropic (TEXF_MIP) — three frames;
- ``tex_deferred``: the same, nearest, ``tex_mode="deferred"`` (the vis
  mode and the deferred tail) — three frames;
- ``textures_trilinear``: structured_scene.obj (1,023,442 triangles,
  micro path), trilinear (TEXF_MIP) — three frames;
- ``textures_anisotropic``: the same, anisotropic (TEXF_MIP) — one frame;
- ``textures_deferred_trilinear``: the same, trilinear,
  ``tex_mode="deferred"`` (vis and the mip tail) — one frame.

Each array is (frames, 768, 1024, 4) uint8. The mode each row takes is
read from the raster calls the JAX package traces, and asserted; each
row's covered pixels are printed. The scenes are synthesized into the
gitignored ``assets/`` on first use (io/objgen.py). ``chip_smoke.py``,
tests/test_torch_mip.py and tests/test_torch_vis.py hold the PyTorch
port's frames against this file, since the machine with the card has no
JAX.

The engine's ``Renderer`` is not used: it bakes the geometry into the
compiled step as constants, which at a million triangles costs far more
compile time and memory than the frames.

Run from the repository root (about four minutes on an 8-core CPU):

    JAX_PLATFORMS=cpu python scripts/make_torch_mip_golden.py
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from compute_renderer_tpu.backends import (  # noqa: E402
    pallas_micro,
    pallas_raster,
    tpu,
)
from compute_renderer_tpu.core.camera import CameraMode  # noqa: E402
from compute_renderer_tpu.engine.scene import (  # noqa: E402
    CameraConfig,
    Scene,
    SceneConfig,
)
from compute_renderer_tpu.io.objgen import (  # noqa: E402
    STRUCTURED_NAME,
    STRUCTURED_TEX_NAME,
)
from compute_renderer_tpu.io.textures import trilinear_tex_arrays  # noqa

WIDTH, HEIGHT, DT = 1024, 768, 1.0 / 60.0
CAMERA = (13.566635, 4.0, 24.0)
OUT = os.path.join(ROOT, "tests", "golden_data",
                   "torch_mip_structured_1024x768.npz")
# row name -> (model, filter, tex_mode, frames, (path, kernel mode))
ROWS = {
    "tex_trilinear": (STRUCTURED_TEX_NAME, "trilinear", "fused", 3,
                      ("tile", "texf_mip")),
    "tex_anisotropic": (STRUCTURED_TEX_NAME, "anisotropic", "fused", 3,
                        ("tile", "texf_mip")),
    "tex_deferred": (STRUCTURED_TEX_NAME, "nearest", "deferred", 3,
                     ("tile", "vis")),
    "textures_trilinear": (STRUCTURED_NAME, "trilinear", "fused", 3,
                           ("micro", "texf_mip")),
    "textures_anisotropic": (STRUCTURED_NAME, "anisotropic", "fused", 1,
                             ("micro", "texf_mip")),
    "textures_deferred_trilinear": (STRUCTURED_NAME, "trilinear",
                                    "deferred", 1, ("micro", "vis")),
}

# The (path, mode) of every raster call traced, recorded by spies on the
# two launchers the JAX engine calls.
TRACED = []


def _spy(module, name, path):
    real = getattr(module, name)

    def spy(*args, vis=False, texf=False, **kw):
        mode = ("vis" if vis else "texf_mip" if texf == pallas_micro.TEXF_MIP
                else "texf" if texf else "other")
        TRACED.append((path, mode))
        return real(*args, vis=vis, texf=texf, **kw)

    setattr(module, name, spy)


def render_row(model, tex_filter, tex_mode, frames, expect):
    config = SceneConfig(
        model_path=model,
        camera_config=CameraConfig(mode=CameraMode.FIRST_PERSON,
                                   position=CAMERA),
        enable_textures=True, texture_filter=tex_filter,
    )
    scene = Scene.from_config(config, WIDTH, HEIGHT)
    mesh = scene.mesh
    T = mesh.num_triangles
    path = tpu.resolve_path("auto", T)
    pos = jnp.asarray(mesh.positions)
    nrm = jnp.asarray(mesh.normals)
    uvs = jnp.asarray(mesh.uvs)
    tri = jnp.asarray(mesh.indices.astype(np.int32)).reshape(-1, 3)
    assert tpu.texf_eligible(mesh.tex_table)
    kw = {"face_kd": jnp.asarray(mesh.face_kd),
          "face_tex": jnp.asarray(mesh.face_tex),
          "texels": jnp.asarray(mesh.texels),
          "tex_table": jnp.asarray(mesh.tex_table),
          "tex_filter": tex_filter, "tex_mode": tex_mode}
    if tex_filter in ("trilinear", "anisotropic"):
        pool, mips = trilinear_tex_arrays(mesh.texels, mesh.tex_table)
        kw.update(texels=jnp.asarray(pool), tex_mips=jnp.asarray(mips))
    if path == "micro":
        kw.update(pos_soa=pos[tri].transpose(1, 2, 0),
                  nrm_soa=nrm[tri].transpose(1, 2, 0))
        if tex_mode == "fused":
            kw["uv_soa"] = uvs[tri].transpose(1, 2, 0)
    caps = tpu.default_caps(path, T, WIDTH, HEIGHT)
    pair_cap = 0 if path == "micro" else caps["pair_cap"]
    tile_cap = caps["tile_cap"] or 0
    out = []
    TRACED.clear()
    for _ in range(frames):
        u = scene.update(DT)
        while True:
            rgba, _, overflow = tpu.render_frame(
                pos, nrm, uvs, tri, jnp.asarray(u.view_proj),
                jnp.asarray(u.view_position),
                jnp.asarray(u.light_world_pos), jnp.asarray(u.light_color),
                jnp.asarray(u.light_intensity), jnp.asarray(u.effect),
                width=WIDTH, height=HEIGHT, pair_cap=pair_cap,
                tile_cap=tile_cap, path=path, interpret=True, **kw)
            need = np.asarray(overflow)
            if not need.any():
                break
            if need[0]:
                pair_cap = tpu.grow_pair_cap(pair_cap, int(need[0]))
            if need[1]:
                tile_cap = tpu.grow_tile_cap(tile_cap, int(need[1]),
                                             caps["tile_h"], caps["tile_w"])
        out.append(np.asarray(rgba))
    assert set(TRACED) == {expect}, (model, tex_filter, tex_mode, TRACED)
    out = np.stack(out)
    covered = [int((f != np.array([0, 0, 255, 255], np.uint8))
                   .any(axis=-1).sum()) for f in out]
    print(f"{model} {tex_filter} {tex_mode}: T={T}, {expect[0]} path, "
          f"{expect[1]} mode, {out.shape}, covered pixels {covered}",
          flush=True)
    return out, T


def main() -> int:
    _spy(pallas_raster, "raster_shade_tiles", "tile")
    _spy(pallas_micro, "raster_shade_micro", "micro")
    arrays, counts = {}, {}
    for name, row in ROWS.items():
        arrays[name], counts[name] = render_row(*row)
    np.savez_compressed(OUT, triangles=np.array(
        [counts[name] for name in ROWS], np.int64), **arrays)
    print(f"wrote {OUT} ({os.path.getsize(OUT)} bytes): rows {list(ROWS)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
