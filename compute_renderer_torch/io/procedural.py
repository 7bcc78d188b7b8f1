"""Procedural test meshes.

The reference's benchmark models (suzanne.obj, San Miguel, Exterior, Vokselia
Spawn — src/main.rs:150-232) are Git-LFS assets not shipped with the source.
These generators provide deterministic stand-ins at matched triangle counts
for tests and benchmarks:

- ``icosphere(3)`` ~ 1280 tris ~ Suzanne-class (~968 tris);
- ``grid_plane`` / ``torus`` scale to San-Miguel-class counts.

All outputs are SoA `Mesh` with smooth vertex normals and planar UVs.
"""

from __future__ import annotations

import numpy as np

from compute_renderer_torch.core.maths import F32
from compute_renderer_torch.core.types import Mesh


def single_triangle(z: float = 0.0) -> Mesh:
    """One CCW (in screen space after the Y-flip) triangle facing +Z."""
    positions = np.array(
        [[-0.5, -0.5, z], [0.5, -0.5, z], [0.0, 0.5, z]], dtype=F32
    )
    normals = np.tile(np.array([[0, 0, 1]], dtype=F32), (3, 1))
    uvs = np.array([[0, 0], [1, 0], [0.5, 1]], dtype=F32)
    indices = np.array([0, 1, 2], dtype=np.uint32)
    return Mesh(positions, normals, uvs, indices)


def quad(z: float = 0.0, size: float = 1.0) -> Mesh:
    s = size / 2.0
    positions = np.array(
        [[-s, -s, z], [s, -s, z], [s, s, z], [-s, s, z]], dtype=F32
    )
    normals = np.tile(np.array([[0, 0, 1]], dtype=F32), (4, 1))
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=F32)
    indices = np.array([0, 1, 2, 0, 2, 3], dtype=np.uint32)
    return Mesh(positions, normals, uvs, indices)


def cube(size: float = 1.0) -> Mesh:
    """Axis-aligned cube with per-face normals (24 vertices, 12 tris)."""
    s = size / 2.0
    faces = [
        # (normal, four corners CCW seen from outside)
        ((0, 0, 1), [(-s, -s, s), (s, -s, s), (s, s, s), (-s, s, s)]),
        ((0, 0, -1), [(s, -s, -s), (-s, -s, -s), (-s, s, -s), (s, s, -s)]),
        ((1, 0, 0), [(s, -s, s), (s, -s, -s), (s, s, -s), (s, s, s)]),
        ((-1, 0, 0), [(-s, -s, -s), (-s, -s, s), (-s, s, s), (-s, s, -s)]),
        ((0, 1, 0), [(-s, s, s), (s, s, s), (s, s, -s), (-s, s, -s)]),
        ((0, -1, 0), [(-s, -s, -s), (s, -s, -s), (s, -s, s), (-s, -s, s)]),
    ]
    positions, normals, uvs, indices = [], [], [], []
    uv_quad = [(0, 0), (1, 0), (1, 1), (0, 1)]
    for fi, (n, corners) in enumerate(faces):
        base = fi * 4
        positions.extend(corners)
        normals.extend([n] * 4)
        uvs.extend(uv_quad)
        indices.extend([base, base + 1, base + 2, base, base + 2, base + 3])
    return Mesh(
        np.asarray(positions, dtype=F32),
        np.asarray(normals, dtype=F32),
        np.asarray(uvs, dtype=F32),
        np.asarray(indices, dtype=np.uint32),
    )


def icosphere(subdivisions: int = 2, radius: float = 1.0) -> Mesh:
    """Subdivided icosahedron; 20 * 4^n triangles (n=3 -> 1280)."""
    t = (1.0 + np.sqrt(5.0)) / 2.0
    verts = np.array(
        [
            [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
            [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
            [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1],
        ],
        dtype=np.float64,
    )
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [
        (0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
        (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
        (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
        (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1),
    ]
    verts = [tuple(v) for v in verts]
    midpoint_cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key in midpoint_cache:
            return midpoint_cache[key]
        a, b = np.array(verts[i]), np.array(verts[j])
        m = (a + b) / 2.0
        m /= np.linalg.norm(m)
        verts.append(tuple(m))
        idx = len(verts) - 1
        midpoint_cache[key] = idx
        return idx

    for _ in range(subdivisions):
        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts, dtype=F32) * F32(radius)
    n = np.asarray(verts, dtype=F32)  # unit sphere -> normal == position dir
    # Spherical UVs.
    uvs = np.stack(
        [
            0.5 + np.arctan2(n[:, 2], n[:, 0]) / (2 * np.pi),
            0.5 - np.arcsin(np.clip(n[:, 1], -1, 1)) / np.pi,
        ],
        axis=1,
    ).astype(F32)
    indices = np.asarray(faces, dtype=np.uint32).reshape(-1)
    return Mesh(v, n, uvs, indices)


def grid_plane(nx: int = 32, nz: int = 32, size: float = 10.0,
               height_fn=None) -> Mesh:
    """(nx*nz*2)-triangle XZ plane, optional heightfield for normals."""
    xs = np.linspace(-size / 2, size / 2, nx + 1)
    zs = np.linspace(-size / 2, size / 2, nz + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    gy = np.zeros_like(gx) if height_fn is None else height_fn(gx, gz)
    positions = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(F32)
    normals = np.tile(np.array([[0, 1, 0]], dtype=F32), (positions.shape[0], 1))
    u, v = np.meshgrid(
        np.linspace(0, 1, nx + 1), np.linspace(0, 1, nz + 1), indexing="ij"
    )
    uvs = np.stack([u, v], axis=-1).reshape(-1, 2).astype(F32)

    idx = []
    stride = nz + 1
    for i in range(nx):
        for j in range(nz):
            a = i * stride + j
            b = (i + 1) * stride + j
            idx += [a, b, a + 1, a + 1, b, b + 1]
    return Mesh(positions, normals, uvs, np.asarray(idx, dtype=np.uint32))


def torus(major_segments: int = 48, minor_segments: int = 24,
          major_radius: float = 1.0, minor_radius: float = 0.35) -> Mesh:
    """2 * major * minor triangles."""
    u = np.linspace(0, 2 * np.pi, major_segments, endpoint=False)
    v = np.linspace(0, 2 * np.pi, minor_segments, endpoint=False)
    uu, vv = np.meshgrid(u, v, indexing="ij")
    cx = np.cos(uu) * (major_radius + minor_radius * np.cos(vv))
    cy = minor_radius * np.sin(vv)
    cz = np.sin(uu) * (major_radius + minor_radius * np.cos(vv))
    positions = np.stack([cx, cy, cz], axis=-1).reshape(-1, 3).astype(F32)
    nx = np.cos(uu) * np.cos(vv)
    ny = np.sin(vv)
    nz = np.sin(uu) * np.cos(vv)
    normals = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3).astype(F32)
    uvs = np.stack([uu / (2 * np.pi), vv / (2 * np.pi)], axis=-1).reshape(-1, 2).astype(F32)

    idx = []
    for i in range(major_segments):
        for j in range(minor_segments):
            a = i * minor_segments + j
            b = ((i + 1) % major_segments) * minor_segments + j
            a1 = i * minor_segments + (j + 1) % minor_segments
            b1 = ((i + 1) % major_segments) * minor_segments + (j + 1) % minor_segments
            idx += [a, b, a1, a1, b, b1]
    return Mesh(positions, normals, uvs, np.asarray(idx, dtype=np.uint32))


def uv_sphere(nu: int = 64, nv: int = 32, radius: float = 1.0,
              center=(0.0, 0.0, 0.0),
              displace_fn=None) -> Mesh:
    """Lat-long sphere, fully vectorized index generation — scales to
    mega-scene (~1M tri) stand-ins where the dict-based icosphere subdivision
    would take minutes. ``displace_fn(theta, phi) -> dr`` optionally perturbs
    the radius (a 'scanned statue' look with subpixel triangles)."""
    uu = np.linspace(0.0, 2 * np.pi, nu + 1, dtype=np.float64)
    vv = np.linspace(-0.5 * np.pi, 0.5 * np.pi, nv + 1, dtype=np.float64)
    theta, phi = np.meshgrid(uu, vv, indexing="ij")  # (nu+1, nv+1)
    r = radius
    if displace_fn is not None:
        r = radius + displace_fn(theta, phi)
    nx = np.cos(theta) * np.cos(phi)
    ny = np.sin(phi)
    nz = np.sin(theta) * np.cos(phi)
    positions = np.stack(
        [r * nx + center[0], r * ny + center[1], r * nz + center[2]], axis=-1
    ).reshape(-1, 3).astype(F32)
    normals = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3).astype(F32)
    uvs = np.stack(
        [theta / (2 * np.pi), (phi / np.pi) + 0.5], axis=-1
    ).reshape(-1, 2).astype(F32)

    # Vectorized quad -> two-triangle fan (CCW when viewed from outside,
    # matching grid_plane's winding convention).
    i = np.arange(nu, dtype=np.uint32)[:, None]
    j = np.arange(nv, dtype=np.uint32)[None, :]
    a = i * (nv + 1) + j
    b = (i + 1) * (nv + 1) + j
    a1 = a + 1
    b1 = b + 1
    idx = np.stack([a, b, a1, a1, b, b1], axis=-1).reshape(-1)
    return Mesh(positions, normals, uvs, idx.astype(np.uint32))


def _san_miguel_mega() -> Mesh:
    """~1.0M-tri San-Miguel-class stand-in (the reference's low-poly San
    Miguel is ~1M tris, SURVEY §2.1 H6): a large displaced terrain around
    the reference camera spawn plus a dense central 'statue' sphere —
    mostly subpixel triangles from the benchmark viewpoint, which is the
    workload class that forced the micro raster path."""
    terrain = grid_plane(
        600, 600, size=60.0,
        height_fn=lambda x, z: 0.4 * np.sin(x * 0.7) * np.cos(z * 0.7),
    )  # 720k tris
    statue = uv_sphere(
        528, 264, radius=3.0, center=(8.0, 2.5, 5.0),
        displace_fn=lambda t, p: 0.15 * np.sin(7 * t) * np.cos(5 * p),
    )  # ~279k tris
    return Mesh.concatenate([terrain, statue])  # ~999k tris


def _vokselia_mega() -> Mesh:
    """~800k-tri Vokselia-class stand-in: blocky displaced terrain."""
    steps = lambda x, z: 0.5 * np.floor(2.0 * np.sin(x * 0.9) * np.cos(z * 0.9))
    return grid_plane(632, 632, size=30.0, height_fn=steps)  # ~799k tris


# Named stand-ins for the reference benchmark models (matched triangle-count
# classes; the real LFS assets are not distributable with the source).
# The heavy scenes match the reference's real triangle classes (San Miguel
# low-poly ~1M, SURVEY §2.1 H6); the round-1 42k/8k variants remain
# available as explicit "_small" rows.
PROCEDURAL_MODELS = {
    "suzanne.obj": lambda: icosphere(3, radius=1.0),  # ~1.3k tris
    "vokselia_spawn/vokselia_spawn.obj": _vokselia_mega,  # ~799k tris
    "vokselia_spawn_small.obj": lambda: grid_plane(
        64, 64, size=20.0,
        height_fn=lambda x, z: 0.5 * np.sin(x * 0.8) * np.cos(z * 0.8),
    ),  # 8k tris
    "exterior/Exterior.obj": lambda: torus(128, 64, 100.0, 40.0),  # 16k tris
    "San_Miguel/san-miguel-low-poly.obj": _san_miguel_mega,  # ~1.0M tris
    "san_miguel_small.obj": lambda: Mesh.concatenate(
        [grid_plane(128, 128, size=40.0,
                    height_fn=lambda x, z: 0.3 * np.sin(x) * np.cos(z)),
         torus(96, 48, 8.0, 3.0)]
    ),  # ~42k tris
}


def make_model(name: str) -> Mesh:
    """Return the procedural stand-in registered under ``name``."""
    if name not in PROCEDURAL_MODELS:
        raise KeyError(f"No procedural model named '{name}'")
    return PROCEDURAL_MODELS[name]()
