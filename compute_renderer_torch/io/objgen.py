"""Structurally-real OBJ synthesis for the benchmark suite.

The reference's benchmark scenes are real multi-submesh OBJ scans loaded
from disk (src/main.rs:154-232, src/model.rs:17-121); those Git-LFS assets
are not distributable with the source, so the suite synthesizes ONE
deterministic scene with the same *structure* a real scan exercises in the
loader and renderer:

- multiple ``o`` objects and ``g`` groups (per-sub-mesh dedup + index
  offsetting on concatenation, model.rs:109-121);
- a shared indexed vertex pool (grid/ring topology: each interior vertex
  referenced by ~6 faces — real dedup behavior, not the 1:1 of a
  triangle-soup export);
- QUAD faces (fan triangulation, tobj ``triangulate: true``);
- every face-token form: ``v/vt/vn``, ``v//vn`` (no texcoords), bare ``v``
  (zero-filled attributes), and negative (relative) indices;
- ``mtllib``/``usemtl``/``s`` statements, with a real companion MTL
  library on disk (discarded by the default loader, model.rs:24; resolved
  into per-triangle diffuse by the opt-in material extension);
- mixed triangle scales: a broad terrain, a dense near-subpixel statue,
  and scattered mid-size blocks — the density mix that drives the binning
  capacity heuristics.

``ensure_structured_scene()`` writes the ~1M-triangle scene once into the
repo-adjacent ``assets/`` search dir (io/assets.py) and caches it, so the
suite row loads through the real path: Model.load -> OBJ parser ->
renderer.

A copy of the JAX package's ``io/objgen.py``: both packages write the
same bytes, so either one's cached assets serve the other.
"""

from __future__ import annotations

import io
import os
from pathlib import Path

import numpy as np

STRUCTURED_NAME = "structured_scene.obj"
STRUCTURED_TEX_NAME = "structured_scene_tex.obj"

# Bumped whenever the synthesized geometry changes, so cached assets from
# older builds regenerate (the header's version line is the check).
# v2: terrain quads re-wound up-facing (v1's were back-face-culled from
# above-ground cameras).
OBJGEN_VERSION = 2
_HEADER = b"# synthesized structurally-real benchmark scene v%d\n"


def _asset_current(path: Path) -> bool:
    """True when ``path`` exists and carries the current version header."""
    try:
        with open(path, "rb") as f:
            return f.readline() == _HEADER % OBJGEN_VERSION
    except OSError:
        return False


def _terrain_block(out, nu: int, nv: int, size: float):
    """Shared-vertex height-field terrain as QUAD faces, full v/vt/vn."""
    xs = np.linspace(-size / 2, size / 2, nu + 1)
    zs = np.linspace(-size / 2, size / 2, nv + 1)
    x = np.repeat(xs, nv + 1)
    z = np.tile(zs, nu + 1)
    y = 0.4 * np.sin(x * 0.7) * np.cos(z * 0.7)
    pos = np.stack([x, y, z], axis=1)

    # Finite-difference normals of the analytic height field.
    dy_dx = 0.4 * 0.7 * np.cos(x * 0.7) * np.cos(z * 0.7)
    dy_dz = -0.4 * 0.7 * np.sin(x * 0.7) * np.sin(z * 0.7)
    n = np.stack([-dy_dx, np.ones_like(x), -dy_dz], axis=1)
    n /= np.linalg.norm(n, axis=1, keepdims=True)

    uv = np.stack([x / size + 0.5, z / size + 0.5], axis=1)

    out.write(b"o terrain\nusemtl ground\ns off\n")
    np.savetxt(out, pos, fmt="v %.7g %.7g %.7g")
    np.savetxt(out, uv, fmt="vt %.7g %.7g")
    np.savetxt(out, n, fmt="vn %.7g %.7g %.7g")

    i = np.arange(nu, dtype=np.int64)[:, None]
    j = np.arange(nv, dtype=np.int64)[None, :]
    a = (i * (nv + 1) + j + 1).ravel()  # 1-based
    b = a + (nv + 1)
    # Cyclic quad (a, a+1, b+1, b): fan-triangulates to UP-facing (+y)
    # triangles, agreeing with the analytic up-facing vn records above —
    # the flipped order shipped through round 3 made the whole terrain
    # back-face-culled from any above-ground camera (v1 assets carry it;
    # the ensure_* version check regenerates them).
    quad = np.stack([a, a + 1, b + 1, b], axis=1)
    np.savetxt(
        out, np.repeat(quad, 3, axis=1),
        fmt="f %d/%d/%d %d/%d/%d %d/%d/%d %d/%d/%d",
    )
    return 2 * nu * nv, (nu + 1) * (nv + 1), (nu + 1) * (nv + 1)


def _statue_block(out, nu: int, nv: int, radius: float, center, v0: int,
                  vn0: int):
    """Dense displaced sphere as v//vn triangles (NO texcoords), split into
    two ``g`` groups at the equator (per-group dedup duplicates the shared
    equator ring — what multi-group scans do)."""
    theta = np.linspace(0, np.pi, nv + 1)
    phi = np.linspace(0, 2 * np.pi, nu + 1)
    t = np.repeat(theta, nu + 1)
    p = np.tile(phi, nv + 1)
    r = radius * (1.0 + 0.05 * np.sin(7 * t) * np.cos(5 * p))
    sx = np.sin(t) * np.cos(p)
    sy = np.cos(t)
    sz = np.sin(t) * np.sin(p)
    pos = np.stack(
        [center[0] + r * sx, center[1] + r * sy, center[2] + r * sz], axis=1
    )
    nrm = np.stack([sx, sy, sz], axis=1)  # radial (close enough for a scan)

    out.write(b"o statue\nusemtl marble\n")
    np.savetxt(out, pos, fmt="v %.7g %.7g %.7g")
    np.savetxt(out, nrm, fmt="vn %.7g %.7g %.7g")

    tris = 0
    half = nv // 2
    for g, (r0, r1) in enumerate(((0, half), (half, nv))):
        out.write(f"g statue_hemisphere_{g}\n".encode())
        i = np.arange(r0, r1, dtype=np.int64)[:, None]
        j = np.arange(nu, dtype=np.int64)[None, :]
        a = (i * (nu + 1) + j).ravel()
        rows = np.stack(
            [a, a + nu + 1, a + nu + 2, a, a + nu + 2, a + 1], axis=1
        ).reshape(-1, 3)
        vidx = rows + v0 + 1
        nidx = rows + vn0 + 1
        faces = np.empty((rows.shape[0], 6), np.int64)
        faces[:, 0::2] = vidx
        faces[:, 1::2] = nidx
        np.savetxt(out, faces, fmt="f %d//%d %d//%d %d//%d")
        tris += rows.shape[0]
    return tris, pos.shape[0], nrm.shape[0]


def _ruins_block(out, count: int, spread: float, v0: int):
    """Scattered boxes as BARE ``f v v v`` triangles (no vt/vn: attributes
    zero-fill, model.rs:61-75). Deterministic placement."""
    rng = np.random.default_rng(20260817)
    cx = rng.uniform(-spread, spread, count)
    cz = rng.uniform(-spread, spread, count)
    s = rng.uniform(0.2, 0.9, count)
    h = rng.uniform(0.4, 2.2, count)

    corners = np.array(
        [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],
         [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]], np.float64
    )
    box_faces = np.array(
        [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
         [0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5],
         [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]], np.int64
    )
    out.write(b"o ruins\nusemtl stone\n")
    verts = np.empty((count * 8, 3))
    for k in range(count):
        v = corners.copy()
        v[:, 0] = v[:, 0] * s[k] + cx[k]
        v[:, 2] = v[:, 2] * s[k] + cz[k]
        v[:, 1] = v[:, 1] * h[k]
        verts[k * 8:(k + 1) * 8] = v
    np.savetxt(out, verts, fmt="v %.7g %.7g %.7g")
    faces = (
        box_faces[None, :, :] + 8 * np.arange(count, dtype=np.int64)[:, None, None]
    ).reshape(-1, 3) + v0 + 1
    np.savetxt(out, faces, fmt="f %d %d %d")
    return faces.shape[0], count * 8


def _banner_block(out):
    """A tiny object using NEGATIVE (relative) indices — spec-legal,
    present in hand-edited scans, exercised by the loader tests."""
    out.write(b"o banner\n")
    out.write(b"v 6 3.5 4\nv 7 3.5 4\nv 7 4.5 4\nv 6 4.5 4\n")
    out.write(b"f -4 -3 -2 -1\n")  # relative quad -> 2 triangles
    return 2, 4


def write_structured_obj(path, terrain_n: int = 600, statue_nu: int = 530,
                         statue_nv: int = 284, ruins: int = 200,
                         size: float = 60.0, mtl_name: str | None = None,
                         mtl_text: str | None = None) -> dict:
    """Write the deterministic multi-submesh scene; returns stats.

    ``mtl_name``/``mtl_text`` override the companion MTL library (the
    textured variant points its materials at generated map_Kd images)."""
    if mtl_name is None:
        mtl_name = "structured_scene.mtl"
    buf = io.BytesIO()
    buf.write(_HEADER % OBJGEN_VERSION)
    buf.write(b"mtllib %s\n" % mtl_name.encode())
    t_tris, t_v, t_vn = _terrain_block(buf, terrain_n, terrain_n, size)
    s_tris, s_v, s_vn = _statue_block(
        buf, statue_nu, statue_nv, radius=3.0, center=(8.0, 2.5, 5.0),
        v0=t_v, vn0=t_vn,
    )
    r_tris, r_v = _ruins_block(buf, ruins, spread=size * 0.45,
                               v0=t_v + s_v)
    b_tris, b_v = _banner_block(buf)
    data = buf.getvalue()
    tmp = str(path) + ".tmp"
    with open(tmp, "wb") as f:
        f.write(data)
    os.replace(tmp, path)
    # The companion MTL library the obj's mtllib names. The default loader
    # discards it (reference-faithful, model.rs:24); Model.load(...,
    # materials=True) resolves the usemtl runs above into per-triangle
    # diffuse — so the SAME synthesized scene also exercises the
    # loader -> face_kd -> render path of the material extension. The
    # banner has no usemtl: its faces get identity white.
    mtl_path = Path(path).parent / mtl_name
    mtl_tmp = str(mtl_path) + ".tmp"
    with open(mtl_tmp, "w") as f:
        f.write(
            mtl_text
            if mtl_text is not None else
            "newmtl ground\nKd 0.35 0.45 0.20\n"
            "newmtl marble\nKd 0.85 0.85 0.80\n"
            "newmtl stone\nKd 0.55 0.50 0.45\n"
        )
    os.replace(mtl_tmp, mtl_path)
    return {
        "triangles": t_tris + s_tris + r_tris + b_tris,
        "vertices": t_v + s_v + r_v + b_v,
        "bytes": len(data),
    }


def ensure_textured_scene(directory: Path | None = None) -> Path:
    """Synthesize the textured suite scene (idempotent): a smaller build of
    the structured scene (~36k tris — single-chunk on the tpu tile path)
    whose MTL materials carry generated ``map_Kd`` images, so the suite row
    exercises the full texture extension end-to-end: OBJ parse -> MTL ->
    image decode -> atlas -> texture-mode raster -> sampling tail."""
    if directory is None:
        from compute_renderer_torch.io.assets import asset_search_dirs

        directory = asset_search_dirs()[-1]
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / STRUCTURED_TEX_NAME
    # Deterministic textures: a ground checker and a marble-ish gradient.
    # Written BEFORE the cached-OBJ early return (idempotent): if the
    # gitignored PPMs were cleaned while the OBJ survived, the atlas would
    # otherwise silently degrade every texture to a 1x1 white texel.
    _write_shared_textures(directory)
    mtl_text = (
        "newmtl ground\nKd 1 1 1\nmap_Kd structured_ground.ppm\n"
        "newmtl marble\nKd 0.95 0.95 0.9\nmap_Kd structured_marble.ppm\n"
        "newmtl stone\nKd 0.55 0.50 0.45\n"
    )
    if _asset_current(path):
        mtl_path = directory / "structured_scene_tex.mtl"
        if not mtl_path.exists():
            mtl_path.write_text(mtl_text)
        return path

    stats = write_structured_obj(
        path, terrain_n=120, statue_nu=80, statue_nv=44, ruins=40,
        mtl_name="structured_scene_tex.mtl", mtl_text=mtl_text,
    )
    print(
        f"[objgen] synthesized {path} "
        f"({stats['triangles']} tris, {stats['bytes'] / 1e6:.1f} MB)"
    )
    return path


def _write_shared_textures(directory: Path) -> None:
    """The two deterministic map_Kd images both structured scenes name."""
    from compute_renderer_torch.io.textures import write_ppm

    n = 64
    yy, xx = np.mgrid[0:n, 0:n]
    checker = np.where(
        ((yy // 8 + xx // 8) % 2 == 0)[..., None],
        np.array([0.45, 0.55, 0.25]),
        np.array([0.25, 0.35, 0.15]),
    )
    write_ppm(directory / "structured_ground.ppm", checker)
    m = 32
    gy, gx = np.mgrid[0:m, 0:m]
    marble = np.stack(
        [0.75 + 0.2 * np.sin(gx * 0.7 + gy * 0.3),
         0.75 + 0.2 * np.sin(gx * 0.5 + 1.0),
         0.72 + 0.2 * np.cos(gy * 0.6)],
        axis=-1,
    ).clip(0, 1)
    write_ppm(directory / "structured_marble.ppm", marble)


# The mega scene's MTL: Kd rows for the material extension, map_Kd images
# for the texture extension (both ignored by the default reference-faithful
# loader). Kd values match the original material-row library so the
# materials suite row is unaffected by the map_Kd additions.
_STRUCTURED_MTL = (
    "newmtl ground\nKd 0.35 0.45 0.20\nmap_Kd structured_ground.ppm\n"
    "newmtl marble\nKd 0.85 0.85 0.80\nmap_Kd structured_marble.ppm\n"
    "newmtl stone\nKd 0.55 0.50 0.45\n"
)


def ensure_structured_scene(directory: Path | None = None) -> Path:
    """Synthesize the ~1M-tri suite scene into the asset search chain
    (idempotent: cached on disk after the first call)."""
    if directory is None:
        from compute_renderer_torch.io.assets import asset_search_dirs

        directory = asset_search_dirs()[-1]  # repo-adjacent assets/
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    path = directory / STRUCTURED_NAME
    mtl_path = directory / "structured_scene.mtl"
    if not _asset_current(path):
        stats = write_structured_obj(path, mtl_text=_STRUCTURED_MTL)
        print(
            f"[objgen] synthesized {path} "
            f"({stats['triangles']} tris, {stats['bytes'] / 1e6:.1f} MB)"
        )
    elif (not mtl_path.exists()
          or "map_Kd" not in mtl_path.read_text()):
        # Scene cached by an older build whose MTL predates the texture
        # row: refresh the library in place (geometry unchanged).
        mtl_path.write_text(_STRUCTURED_MTL)
    _write_shared_textures(directory)
    return path
