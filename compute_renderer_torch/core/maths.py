"""f32 matrix math matching glam's conventions (the reference's math library).

The reference builds its camera matrices with ``glam``'s ``Mat4::look_at_rh``
and ``Mat4::perspective_rh`` (reference src/camera.rs:91-95). We reproduce the
same formulas in float32 numpy so the resulting view-projection matrices are
bit-identical for identical inputs.

Convention: matrices are stored row-major and applied as ``M @ v`` with ``v``
a column vector — i.e. ``transform(M, p) = M @ [p, 1]``. This matches glam's
column-vector convention (glam stores column-major, but the linear map is the
same).
"""

from __future__ import annotations

import numpy as np

F32 = np.float32

# Anisotropic-filtering tap count AND the footprint clamp baked into the
# per-triangle mip constants of the texture extension
# (``backends/common.py``'s ``mip_tri_rows`` and samplers, and the oracle,
# ``golden/rasterizer.py``). ONE constant, so the table build and every
# sampler can never desynchronize: a table baked at one value but shaded
# at another would silently mis-scale the filter footprint.
MAX_ANISO = 4


def normalize(v: np.ndarray) -> np.ndarray:
    v = v.astype(F32)
    n = F32(np.sqrt(F32(v[0] * v[0] + v[1] * v[1] + v[2] * v[2])))
    return (v / n).astype(F32)


def cross(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    a = a.astype(F32)
    b = b.astype(F32)
    return np.array(
        [
            a[1] * b[2] - a[2] * b[1],
            a[2] * b[0] - a[0] * b[2],
            a[0] * b[1] - a[1] * b[0],
        ],
        dtype=F32,
    )


def dot(a: np.ndarray, b: np.ndarray) -> F32:
    a = a.astype(F32)
    b = b.astype(F32)
    return F32(a[0] * b[0] + a[1] * b[1] + a[2] * b[2])


def look_at_rh(eye: np.ndarray, center: np.ndarray, up: np.ndarray) -> np.ndarray:
    """Right-handed look-at view matrix (glam Mat4::look_at_rh semantics)."""
    eye = np.asarray(eye, dtype=F32)
    center = np.asarray(center, dtype=F32)
    up = np.asarray(up, dtype=F32)

    f = normalize(center - eye)  # forward
    s = normalize(cross(f, up))  # right
    u = cross(s, f)  # recomputed up

    m = np.zeros((4, 4), dtype=F32)
    m[0, :3] = s
    m[1, :3] = u
    m[2, :3] = -f
    m[0, 3] = -dot(s, eye)
    m[1, 3] = -dot(u, eye)
    m[2, 3] = dot(f, eye)
    m[3, 3] = F32(1.0)
    return m


def perspective_rh(fovy: float, aspect: float, znear: float, zfar: float) -> np.ndarray:
    """Right-handed perspective projection, depth mapped to [0, 1].

    Matches glam Mat4::perspective_rh (wgpu/DirectX-style 0..1 clip depth),
    which the reference uses (reference src/camera.rs:93).
    """
    fovy = F32(fovy)
    aspect = F32(aspect)
    znear = F32(znear)
    zfar = F32(zfar)

    sin_fov = F32(np.sin(F32(0.5) * fovy))
    cos_fov = F32(np.cos(F32(0.5) * fovy))
    h = F32(cos_fov / sin_fov)
    w = F32(h / aspect)
    r = F32(zfar / (znear - zfar))

    m = np.zeros((4, 4), dtype=F32)
    m[0, 0] = w
    m[1, 1] = h
    m[2, 2] = r
    m[2, 3] = F32(r * znear)
    m[3, 2] = F32(-1.0)
    return m


def transform_point3(m: np.ndarray, p: np.ndarray) -> np.ndarray:
    """Apply a 4x4 matrix to a 3D point (w=1), dropping w (no perspective
    divide) — glam Mat4::transform_point3 on affine matrices, as used for the
    reference's light world->view transform (reference src/scene.rs:149-154)."""
    m = np.asarray(m, dtype=F32)
    p = np.asarray(p, dtype=F32)
    out = m[:3, :3] @ p + m[:3, 3]
    return out.astype(F32)


def to_radians(deg) -> F32:
    return F32(np.deg2rad(np.asarray(deg, dtype=F32)))
