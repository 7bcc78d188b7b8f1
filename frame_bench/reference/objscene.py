"""The structured OBJ scene a configuration can name, written to disk for
the program to load and handed to the reference as arrays.

A frozen copy of the port's ``io/objgen.py`` at its version 2 (the
writer ``write_structured_obj`` with its terrain, statue, ruins and
banner blocks; the two MTL libraries; the two ``map_Kd`` images and the
PPM writer), as ``geometry.py`` froze ``io/procedural.py``: the same
arithmetic and the same bytes, so that the benchmark's scene stays what
it is when the program's copy changes. The part's parameters are the
writer's (``terrain_n``, ``statue_nu``, ``statue_nv``, ``ruins``,
``size``), the MTL it names (``mtl``: ``"structured"``, the full
scene's, or ``"structured_tex"``, the 36k build's) and the sizes of the
two images (``ground_px``, ``marble_px``; objgen's 64 and 32).

The reference's arrays come straight from the generator, never from the
program's loader: each vertex's floats as a parser reads them back from
the text written (``%.7g``, then float32), the triangles as the OBJ's
faces fan out (quads as (0, 1, 2), (0, 2, 3)) in file order, a corner
without ``vt`` or ``vn`` zero-filled, ``v`` flipped to ``1 - v`` where
the object has texture coordinates, each face's material the last
``usemtl`` before it (the banner keeps the ruins' ``stone``), its Kd and
its image from the MTL text, the images as the PPM's bytes over 255.

Imports nothing of the program.
"""

from __future__ import annotations

import io
import shutil
from pathlib import Path

import numpy as np

F32 = np.float32
KIND = "structured_obj"
OBJGEN_VERSION = 2
_HEADER = b"# synthesized structurally-real benchmark scene v%d\n"
# Not objgen's names (structured_scene.obj, structured_scene_tex.obj):
# the program's loader regenerates files of those names itself.
OBJ_NAME = "frame_bench_scene.obj"
MTL_NAME = "frame_bench_scene.mtl"

MTL_TEXTS = {
    # objgen's _STRUCTURED_MTL: the full scene's library.
    "structured": (
        "newmtl ground\nKd 0.35 0.45 0.20\nmap_Kd structured_ground.ppm\n"
        "newmtl marble\nKd 0.85 0.85 0.80\nmap_Kd structured_marble.ppm\n"
        "newmtl stone\nKd 0.55 0.50 0.45\n"
    ),
    # ensure_textured_scene's library: the 36k build's.
    "structured_tex": (
        "newmtl ground\nKd 1 1 1\nmap_Kd structured_ground.ppm\n"
        "newmtl marble\nKd 0.95 0.95 0.9\nmap_Kd structured_marble.ppm\n"
        "newmtl stone\nKd 0.55 0.50 0.45\n"
    ),
}


def is_obj(parts):
    """Whether the geometry is one OBJ part (an OBJ part stands alone)."""
    kinds = [p["kind"] for p in parts]
    if KIND in kinds and len(kinds) > 1:
        raise ValueError(f"a {KIND} part stands alone, not with {kinds}")
    return kinds == [KIND]


def _emit(out, values, fmt):
    """Write ``values`` (n, k) as ``fmt`` lines; return the float32 values
    a parser reads back from those lines."""
    buf = io.BytesIO()
    np.savetxt(buf, values, fmt=fmt)
    text = buf.getvalue()
    out.write(text)
    back = np.loadtxt(io.BytesIO(text), usecols=range(1, values.shape[1] + 1),
                      dtype=np.float64, ndmin=2)
    return back.astype(F32)


def _terrain_block(out, nu, nv, size):
    """Shared-vertex height-field terrain as QUAD faces, full v/vt/vn."""
    xs = np.linspace(-size / 2, size / 2, nu + 1)
    zs = np.linspace(-size / 2, size / 2, nv + 1)
    x = np.repeat(xs, nv + 1)
    z = np.tile(zs, nu + 1)
    y = 0.4 * np.sin(x * 0.7) * np.cos(z * 0.7)
    pos = np.stack([x, y, z], axis=1)
    dy_dx = 0.4 * 0.7 * np.cos(x * 0.7) * np.cos(z * 0.7)
    dy_dz = -0.4 * 0.7 * np.sin(x * 0.7) * np.sin(z * 0.7)
    n = np.stack([-dy_dx, np.ones_like(x), -dy_dz], axis=1)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    uv = np.stack([x / size + 0.5, z / size + 0.5], axis=1)

    out.write(b"o terrain\nusemtl ground\ns off\n")
    p32 = _emit(out, pos, "v %.7g %.7g %.7g")
    t32 = _emit(out, uv, "vt %.7g %.7g")
    n32 = _emit(out, n, "vn %.7g %.7g %.7g")

    i = np.arange(nu, dtype=np.int64)[:, None]
    j = np.arange(nv, dtype=np.int64)[None, :]
    a = (i * (nv + 1) + j + 1).ravel()  # 1-based
    b = a + (nv + 1)
    # Cyclic quad (a, a+1, b+1, b): up-facing triangles.
    quad = np.stack([a, a + 1, b + 1, b], axis=1)
    np.savetxt(out, np.repeat(quad, 3, axis=1),
               fmt="f %d/%d/%d %d/%d/%d %d/%d/%d %d/%d/%d")
    uvs = np.stack([t32[:, 0], F32(1.0) - t32[:, 1]], axis=1)
    return p32, n32, uvs, _fan(quad - 1)


def _statue_block(out, nu, nv, radius, center, v0, vn0):
    """Dense displaced sphere as v//vn triangles (no texcoords), split into
    two ``g`` groups at the equator."""
    theta = np.linspace(0, np.pi, nv + 1)
    phi = np.linspace(0, 2 * np.pi, nu + 1)
    t = np.repeat(theta, nu + 1)
    p = np.tile(phi, nv + 1)
    r = radius * (1.0 + 0.05 * np.sin(7 * t) * np.cos(5 * p))
    sx = np.sin(t) * np.cos(p)
    sy = np.cos(t)
    sz = np.sin(t) * np.sin(p)
    pos = np.stack(
        [center[0] + r * sx, center[1] + r * sy, center[2] + r * sz], axis=1)
    nrm = np.stack([sx, sy, sz], axis=1)

    out.write(b"o statue\nusemtl marble\n")
    p32 = _emit(out, pos, "v %.7g %.7g %.7g")
    n32 = _emit(out, nrm, "vn %.7g %.7g %.7g")

    tris = []
    half = nv // 2
    for g, (r0, r1) in enumerate(((0, half), (half, nv))):
        out.write(f"g statue_hemisphere_{g}\n".encode())
        i = np.arange(r0, r1, dtype=np.int64)[:, None]
        j = np.arange(nu, dtype=np.int64)[None, :]
        a = (i * (nu + 1) + j).ravel()
        rows = np.stack(
            [a, a + nu + 1, a + nu + 2, a, a + nu + 2, a + 1], axis=1
        ).reshape(-1, 3)
        faces = np.empty((rows.shape[0], 6), np.int64)
        faces[:, 0::2] = rows + v0 + 1
        faces[:, 1::2] = rows + vn0 + 1
        np.savetxt(out, faces, fmt="f %d//%d %d//%d %d//%d")
        tris.append(rows)
    return p32, n32, np.zeros((len(p32), 2), F32), np.concatenate(tris)


def _ruins_block(out, count, spread, v0):
    """Scattered boxes as bare ``f v v v`` triangles (no vt/vn).
    Deterministic placement."""
    rng = np.random.default_rng(20260817)
    cx = rng.uniform(-spread, spread, count)
    cz = rng.uniform(-spread, spread, count)
    s = rng.uniform(0.2, 0.9, count)
    h = rng.uniform(0.4, 2.2, count)
    corners = np.array(
        [[-1, 0, -1], [1, 0, -1], [1, 0, 1], [-1, 0, 1],
         [-1, 1, -1], [1, 1, -1], [1, 1, 1], [-1, 1, 1]], np.float64)
    box_faces = np.array(
        [[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
         [0, 1, 5], [0, 5, 4], [1, 2, 6], [1, 6, 5],
         [2, 3, 7], [2, 7, 6], [3, 0, 4], [3, 4, 7]], np.int64)
    out.write(b"o ruins\nusemtl stone\n")
    verts = np.empty((count * 8, 3))
    for k in range(count):
        v = corners.copy()
        v[:, 0] = v[:, 0] * s[k] + cx[k]
        v[:, 2] = v[:, 2] * s[k] + cz[k]
        v[:, 1] = v[:, 1] * h[k]
        verts[k * 8:(k + 1) * 8] = v
    p32 = _emit(out, verts, "v %.7g %.7g %.7g")
    faces = (box_faces[None, :, :]
             + 8 * np.arange(count, dtype=np.int64)[:, None, None]
             ).reshape(-1, 3)
    np.savetxt(out, faces + v0 + 1, fmt="f %d %d %d")
    return _bare(p32, faces)


def _banner_block(out):
    """A tiny object with negative (relative) indices."""
    out.write(b"o banner\n")
    out.write(b"v 6 3.5 4\nv 7 3.5 4\nv 7 4.5 4\nv 6 4.5 4\n")
    out.write(b"f -4 -3 -2 -1\n")  # relative quad -> 2 triangles
    p32 = np.array([[6, 3.5, 4], [7, 3.5, 4], [7, 4.5, 4], [6, 4.5, 4]], F32)
    return _bare(p32, _fan(np.array([[0, 1, 2, 3]], np.int64)))


def _bare(p32, tri):
    """An object of bare ``v`` corners: normals and uvs zero-filled."""
    return (p32, np.zeros((len(p32), 3), F32), np.zeros((len(p32), 2), F32),
            tri)


def _fan(quads):
    """(q, 4) quads as (2q, 3) triangles, each quad's two in turn."""
    return np.stack([quads[:, [0, 1, 2]], quads[:, [0, 2, 3]]],
                    axis=1).reshape(-1, 3)


def write_ppm(path, img):
    """(H, W, 3) f32 in [0, 1] as binary P6; returns the u8 image."""
    img = np.clip(np.round(np.asarray(img) * 255.0), 0, 255).astype(np.uint8)
    h, w = img.shape[:2]
    with open(path, "wb") as f:
        f.write(b"P6\n%d %d\n255\n" % (w, h))
        f.write(img[:, :, :3].tobytes())
    return img


def _images(n, m):
    """objgen's two map_Kd images at ``n`` and ``m`` texels a side: a
    ground checker of 8-texel squares and a marble-ish gradient."""
    yy, xx = np.mgrid[0:n, 0:n]
    checker = np.where(
        ((yy // 8 + xx // 8) % 2 == 0)[..., None],
        np.array([0.45, 0.55, 0.25]),
        np.array([0.25, 0.35, 0.15]),
    )
    gy, gx = np.mgrid[0:m, 0:m]
    marble = np.stack(
        [0.75 + 0.2 * np.sin(gx * 0.7 + gy * 0.3),
         0.75 + 0.2 * np.sin(gx * 0.5 + 1.0),
         0.72 + 0.2 * np.cos(gy * 0.6)],
        axis=-1,
    ).clip(0, 1)
    return {"structured_ground.ppm": checker, "structured_marble.ppm": marble}


def _materials(text):
    """{name: (Kd float32 (3,), map_Kd file or None)} of an MTL text."""
    out, cur = {}, None
    for line in text.splitlines():
        parts = line.split()
        if not parts:
            continue
        if parts[0] == "newmtl":
            cur = " ".join(parts[1:])
            out[cur] = [np.ones(3, F32), None]
        elif parts[0] == "Kd":
            out[cur][0] = np.array(parts[1:4], dtype=F32)
        elif parts[0] == "map_Kd":
            out[cur][1] = parts[-1]
    return out


class ObjScene:
    """Writes ``part``'s OBJ, MTL and PPM files into ``directory``
    (``path``: the OBJ) and holds the reference's arrays: ``positions``,
    ``normals`` (N, 3) f32, ``uvs`` (N, 2) f32, ``tri`` (T, 3) int64, ``face_kd``
    (T, 3) f32, ``face_image`` (T,) int32 (-1: no image) and ``images``,
    a list of (h, w, 3) f32."""

    def __init__(self, directory, part):
        self.directory = Path(directory)
        self.path = self.directory / OBJ_NAME
        size = float(part.get("size", 60.0))
        mtl = MTL_TEXTS[part.get("mtl", "structured")]
        out = io.BytesIO()
        out.write(_HEADER % OBJGEN_VERSION)
        out.write(b"mtllib %s\n" % MTL_NAME.encode())
        n = int(part.get("terrain_n", 600))
        terrain = _terrain_block(out, n, n, size)
        v0 = len(terrain[0])
        statue = _statue_block(
            out, int(part.get("statue_nu", 530)),
            int(part.get("statue_nv", 284)), radius=3.0,
            center=(8.0, 2.5, 5.0), v0=v0, vn0=v0)
        ruins = _ruins_block(out, int(part.get("ruins", 200)),
                             spread=size * 0.45, v0=v0 + len(statue[0]))
        banner = _banner_block(out)
        self.path.write_bytes(out.getvalue())
        (self.directory / MTL_NAME).write_text(mtl)

        objects = (terrain, statue, ruins, banner)
        self.positions, self.normals, self.uvs = (
            np.concatenate([o[k] for o in objects]) for k in range(3))
        starts = np.cumsum([0] + [len(o[0]) for o in objects])
        self.tri = np.concatenate([o[3] + v for o, v in zip(objects, starts)])

        written = {name: write_ppm(self.directory / name, img)
                   for name, img in _images(int(part.get("ground_px", 64)),
                                            int(part.get("marble_px", 32))
                                            ).items()}
        materials = _materials(mtl)
        # One image a distinct map_Kd file, in the MTL's order.
        files = list(dict.fromkeys(f for _, f in materials.values()
                                   if f is not None))
        self.images = [written[f].astype(F32) / F32(255.0) for f in files]
        # Each face's material is the last usemtl before it: the banner,
        # which names none, keeps the ruins' "stone".
        counts = {"ground": len(terrain[3]), "marble": len(statue[3]),
                  "stone": len(ruins[3]) + len(banner[3])}
        self.face_kd = np.concatenate(
            [np.tile(materials[m][0], (n, 1)) for m, n in counts.items()])
        self.face_image = np.concatenate(
            [np.full(n, files.index(materials[m][1])
                     if materials[m][1] is not None else -1, np.int32)
             for m, n in counts.items()])

    def remove_files(self):
        shutil.rmtree(self.directory, ignore_errors=True)
