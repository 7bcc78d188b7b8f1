"""The configurations' geometry, built from the parts a configuration file
lists (``"geometry"``): a frozen copy of the stand-in generators of the
port's ``io/procedural.py`` (``icosphere``, ``grid_plane``, ``uv_sphere``,
concatenated with offset indices as ``Mesh.concatenate``), so that the
benchmark's scenes stay what they are when the program's copy changes.

The arithmetic is the original's, element for element; only the index
loops of ``grid_plane`` are vectorised (the same integers). Heightfields
and displacements are data: ``{"amp", "fx", "fz", "steps"}`` gives
``amp * sin(x * fx) * cos(z * fz)`` (``steps``: ``amp * floor(2 sin cos)``,
the blocky terrain), ``{"amp", "ft", "fp"}`` on a sphere
``amp * sin(ft * theta) * cos(fp * phi)``.

Imports nothing of the program: the harness turns the arrays into the
program's mesh, and the reference renders them as they are.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def _height(spec):
    if spec is None:
        return None
    amp, fx, fz = spec["amp"], spec["fx"], spec["fz"]
    if spec.get("steps"):
        return lambda x, z: amp * np.floor(2.0 * np.sin(x * fx) * np.cos(z * fz))
    return lambda x, z: amp * np.sin(x * fx) * np.cos(z * fz)


def grid_plane(nx, nz, size, height=None):
    """(nx * nz * 2)-triangle XZ plane with an optional heightfield; the
    normals stay (0, 1, 0), as the original's do."""
    xs = np.linspace(-size / 2, size / 2, nx + 1)
    zs = np.linspace(-size / 2, size / 2, nz + 1)
    gx, gz = np.meshgrid(xs, zs, indexing="ij")
    fn = _height(height)
    gy = np.zeros_like(gx) if fn is None else fn(gx, gz)
    positions = np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(F32)
    normals = np.tile(np.array([[0, 1, 0]], dtype=F32),
                      (positions.shape[0], 1))
    u, v = np.meshgrid(np.linspace(0, 1, nx + 1), np.linspace(0, 1, nz + 1),
                       indexing="ij")
    uvs = np.stack([u, v], axis=-1).reshape(-1, 2).astype(F32)
    stride = nz + 1
    i = np.arange(nx, dtype=np.int64)[:, None]
    j = np.arange(nz, dtype=np.int64)[None, :]
    a = i * stride + j
    b = (i + 1) * stride + j
    idx = np.stack([a, b, a + 1, a + 1, b, b + 1], axis=-1).reshape(-1)
    return positions, normals, uvs, idx.astype(np.uint32)


def uv_sphere(nu, nv, radius, center=(0.0, 0.0, 0.0), displace=None):
    """Lat-long sphere, optionally displaced along the radius."""
    uu = np.linspace(0.0, 2 * np.pi, nu + 1, dtype=np.float64)
    vv = np.linspace(-0.5 * np.pi, 0.5 * np.pi, nv + 1, dtype=np.float64)
    theta, phi = np.meshgrid(uu, vv, indexing="ij")
    r = radius
    if displace is not None:
        r = radius + displace["amp"] * np.sin(displace["ft"] * theta) * np.cos(
            displace["fp"] * phi)
    nx = np.cos(theta) * np.cos(phi)
    ny = np.sin(phi)
    nz = np.sin(theta) * np.cos(phi)
    positions = np.stack(
        [r * nx + center[0], r * ny + center[1], r * nz + center[2]], axis=-1
    ).reshape(-1, 3).astype(F32)
    normals = np.stack([nx, ny, nz], axis=-1).reshape(-1, 3).astype(F32)
    uvs = np.stack([theta / (2 * np.pi), (phi / np.pi) + 0.5],
                   axis=-1).reshape(-1, 2).astype(F32)
    i = np.arange(nu, dtype=np.uint32)[:, None]
    j = np.arange(nv, dtype=np.uint32)[None, :]
    a = i * (nv + 1) + j
    b = (i + 1) * (nv + 1) + j
    idx = np.stack([a, b, a + 1, a + 1, b, b + 1], axis=-1).reshape(-1)
    return positions, normals, uvs, idx.astype(np.uint32)


def icosphere(subdivisions, radius=1.0):
    """Subdivided icosahedron; 20 * 4^n triangles."""
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
    cache = {}

    def midpoint(i, j):
        key = (min(i, j), max(i, j))
        if key in cache:
            return cache[key]
        m = (np.array(verts[i]) + np.array(verts[j])) / 2.0
        m /= np.linalg.norm(m)
        verts.append(tuple(m))
        cache[key] = len(verts) - 1
        return cache[key]

    for _ in range(subdivisions):
        new_faces = []
        for (a, b, c) in faces:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc), (ab, bc, ca)]
        faces = new_faces

    v = np.asarray(verts, dtype=F32) * F32(radius)
    n = np.asarray(verts, dtype=F32)
    uvs = np.stack(
        [
            0.5 + np.arctan2(n[:, 2], n[:, 0]) / (2 * np.pi),
            0.5 - np.arcsin(np.clip(n[:, 1], -1, 1)) / np.pi,
        ],
        axis=1,
    ).astype(F32)
    return v, n, uvs, np.asarray(faces, dtype=np.uint32).reshape(-1)


PARTS = {
    "grid_plane": lambda p: grid_plane(p["nx"], p["nz"], p["size"],
                                       p.get("height")),
    "uv_sphere": lambda p: uv_sphere(p["nu"], p["nv"], p["radius"],
                                     tuple(p.get("center", (0.0, 0.0, 0.0))),
                                     p.get("displace")),
    "icosphere": lambda p: icosphere(p["subdivisions"], p.get("radius", 1.0)),
}


def build(parts):
    """The arrays (positions (N, 3) f32, normals (N, 3) f32, uvs (N, 2)
    f32, indices (3T,) u32) of the listed parts, concatenated in order."""
    pos, nrm, uvs, idx = [], [], [], []
    offset = 0
    for part in parts:
        p, n, u, i = PARTS[part["kind"]](part)
        pos.append(p)
        nrm.append(n)
        uvs.append(u)
        idx.append(i.astype(np.uint32) + np.uint32(offset))
        offset += p.shape[0]
    return (np.concatenate(pos), np.concatenate(nrm), np.concatenate(uvs),
            np.concatenate(idx))
