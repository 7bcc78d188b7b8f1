"""The plain reference's base shading as it stood before the reference
learnt materials and textures: a frozen copy, which the tests hold the
current reference's base frames to, bit for bit."""

from __future__ import annotations

import numpy as np
import torch

TRI_BITS = 24
TRI_MASK = (1 << TRI_BITS) - 1
NO_HIT = (0xFFFFFFFF << TRI_BITS) | TRI_MASK


class Scene:
    """The geometry on ``device``: positions and normals (N, 3) float32
    and the triangles' vertex indices (T, 3) int64."""

    def __init__(self, positions, normals, indices, device):
        self.device = torch.device(device)
        self.positions = torch.as_tensor(np.asarray(positions, np.float32),
                                         device=self.device)
        self.normals = torch.as_tensor(np.asarray(normals, np.float32),
                                       device=self.device)
        tri = np.asarray(indices, np.int64).reshape(-1, 3)
        if tri.shape[0] > TRI_MASK:
            raise ValueError(f"{tri.shape[0]} triangles: the depth resolve "
                             f"holds at most {TRI_MASK}")
        self.tri = torch.as_tensor(tri, device=self.device)


def _screen(scene, view_proj, width, height, dtype):
    p = scene.positions.to(dtype)
    m = torch.as_tensor(np.asarray(view_proj, np.float32),
                        device=scene.device).to(dtype)
    x, y, z = p[:, 0], p[:, 1], p[:, 2]
    cx, cy, cz, w = ((m[r, 0] * x + m[r, 1] * y) + (m[r, 2] * z + m[r, 3])
                     for r in range(4))
    sx = (cx / w + 1.0) * 0.5 * float(width)
    sy = (1.0 - cy / w) * 0.5 * float(height)
    return sx, sy, cz / w, w


def _setup(scene, screen, width, height, cell):
    """Per triangle: its corners' (x, y, z), uz, and the sample rectangle
    [x0, x1) x [y0, y1) (empty for a dropped triangle)."""
    sx, sy, sz, sw = screen
    t = scene.tri
    v = [(sx[t[:, k]], sy[t[:, k]], sz[t[:, k]]) for k in range(3)]
    (v1x, v1y, _), (v2x, v2y, _), (v3x, v3y, _) = v
    w_ok = ~((sw[t[:, 0]] < 0.0) | (sw[t[:, 1]] < 0.0) | (sw[t[:, 2]] < 0.0))
    min_x = torch.minimum(torch.minimum(v1x, v2x), v3x).float()
    max_x = torch.maximum(torch.maximum(v1x, v2x), v3x).float()
    min_y = torch.minimum(torch.minimum(v1y, v2y), v3y).float()
    max_y = torch.maximum(torch.maximum(v1y, v2y), v3y).float()
    on_screen = ~((max_x < 0.0) | (min_x >= float(width))
                  | (max_y < 0.0) | (min_y >= float(height)))
    finite = (torch.isfinite(v1x) & torch.isfinite(v2x) & torch.isfinite(v3x)
              & torch.isfinite(v1y) & torch.isfinite(v2y)
              & torch.isfinite(v3y))
    cross_z = (v2x - v1x) * (v3y - v1y) - (v2y - v1y) * (v3x - v1x)
    alive = w_ok & on_screen & (cross_z < 0.0) & finite
    zero = torch.zeros((), device=scene.device)
    cb_min_x = torch.where(alive, torch.clamp(min_x, min=0.0), zero)
    cb_min_y = torch.where(alive, torch.clamp(min_y, min=0.0), zero)
    cb_max_x = torch.where(alive, torch.clamp(max_x, max=width - 1.0), zero)
    cb_max_y = torch.where(alive, torch.clamp(max_y, max=height - 1.0), zero)
    ntx = (width + cell - 1) // cell
    nty = (height + cell - 1) // cell
    tx0 = torch.clamp(torch.floor(cb_min_x / float(cell)), min=0.0).long()
    ty0 = torch.clamp(torch.floor(cb_min_y / float(cell)), min=0.0).long()
    tx1 = torch.clamp(torch.ceil(cb_max_x / float(cell)), max=ntx).long()
    ty1 = torch.clamp(torch.ceil(cb_max_y / float(cell)), max=nty).long()
    alive = alive & (tx1 > tx0) & (ty1 > ty0)
    x0 = torch.maximum(tx0 * cell, torch.floor(cb_min_x).long() - 1)
    y0 = torch.maximum(ty0 * cell, torch.floor(cb_min_y).long() - 1)
    x1 = torch.minimum(torch.clamp(tx1 * cell, max=width),
                       torch.floor(cb_max_x).long() + 2)
    y1 = torch.minimum(torch.clamp(ty1 * cell, max=height),
                       torch.floor(cb_max_y).long() + 2)
    cw = torch.where(alive, torch.clamp(x1 - x0, min=0), 0)
    ch = torch.where(alive, torch.clamp(y1 - y0, min=0), 0)
    return v, x0, y0, cw, ch


def _barycentric(v, px, py):
    (v1x, v1y, _), (v2x, v2y, _), (v3x, v3y, _) = v
    ux = (v2x - v1x) * (v1y - py) - (v1x - px) * (v2y - v1y)
    uy = (v1x - px) * (v3y - v1y) - (v3x - v1x) * (v1y - py)
    uz = (v3x - v1x) * (v2y - v1y) - (v2x - v1x) * (v3y - v1y)
    return 1.0 - (ux + uy) / uz, uy / uz, ux / uz


def _resolve(scene, v, x0, y0, cw, ch, width, height, dtype, budget):
    """(H * W,) int64: the winning (key << 24 | triangle) of each pixel,
    NO_HIT where none covers it."""
    dev = scene.device
    zbuf = torch.full((height * width,), NO_HIT, dtype=torch.int64,
                      device=dev)
    n = cw * ch
    cum = torch.cumsum(n, 0).cpu().numpy()
    T = int(n.shape[0])
    t0, base = 0, 0
    while t0 < T:
        t1 = max(int(np.searchsorted(cum, base + budget, side="right")),
                 t0 + 1)
        total = int(cum[t1 - 1]) - base
        if total:
            nb = n[t0:t1]
            ids = torch.repeat_interleave(
                torch.arange(t0, t1, device=dev), nb)
            starts = torch.cumsum(nb, 0) - nb
            k = (torch.arange(total, device=dev)
                 - torch.repeat_interleave(starts, nb))
            w = cw[ids]
            px = x0[ids] + k % w
            py = y0[ids] + k // w
            vk = [(a[ids], b[ids], c[ids]) for a, b, c in v]
            b1, b2, b3 = _barycentric(vk, px.to(dtype), py.to(dtype))
            z = b1 * vk[0][2] + b2 * vk[1][2] + b3 * vk[2][2]
            hit = (b1 >= 0.0) & (b2 >= 0.0) & (b3 >= 0.0) & torch.isfinite(z)
            key = z.float().view(torch.int32).long() & 0xFFFFFFFF
            hit &= key < 0xFFFFFFFF
            zbuf.scatter_reduce_(0, (py * width + px)[hit],
                                 ((key << TRI_BITS) | ids)[hit], "amin")
        base = int(cum[t1 - 1])
        t0 = t1
    return zbuf


def _shade(scene, v, t, px, py, vpos, lights, dtype):
    """(n, 3) u8 colours of the winning samples (triangle ``t`` at pixel
    (``px``, ``py``))."""
    dev = scene.device
    vk = [(a[t], b[t], c[t]) for a, b, c in v]
    b1, b2, b3 = _barycentric(vk, px.to(dtype), py.to(dtype))
    idx = scene.tri[t]

    def interp(src):
        s = src.to(dtype)
        a, b, c = s[idx[:, 0]], s[idx[:, 1]], s[idx[:, 2]]
        return [b1 * a[:, ch] + b2 * b[:, ch] + b3 * c[:, ch]
                for ch in range(3)]

    nx, ny, nz = interp(scene.normals)
    wx, wy, wz = interp(scene.positions)

    def scalar(x):
        return torch.tensor(float(np.float32(x)), dtype=dtype, device=dev)

    zero = torch.zeros((), dtype=dtype, device=dev)
    final = [torch.full_like(nx, 0.1) for _ in range(3)]
    ex, ey, ez = (scalar(c) for c in vpos[:3])
    for light in lights:
        lx, ly, lz = (scalar(c) for c in light["position"])
        ldx, ldy, ldz = lx - wx, ly - wy, lz - wz
        ln = torch.sqrt((ldx * ldx + ldy * ldy) + ldz * ldz)
        ldx, ldy, ldz = ldx / ln, ldy / ln, ldz / ln
        diff = torch.fmax((nx * ldx + ny * ldy) + nz * ldz, zero)
        vdx, vdy, vdz = ex - wx, ey - wy, ez - wz
        vn = torch.sqrt((vdx * vdx + vdy * vdy) + vdz * vdz)
        vdx, vdy, vdz = vdx / vn, vdy / vn, vdz / vn
        edx, edy, edz = -ldx, -ldy, -ldz
        r2 = 2.0 * ((edx * nx + edy * ny) + edz * nz)
        rdx, rdy, rdz = edx - r2 * nx, edy - r2 * ny, edz - r2 * nz
        s = torch.fmax((vdx * rdx + vdy * rdy) + vdz * rdz, zero)
        s2 = s * s
        s4 = s2 * s2
        s8 = s4 * s4
        s16 = s8 * s8
        contrib = diff + (s16 * s16) * 0.5
        inten = scalar(light["intensity"])
        for ch in range(3):
            final[ch] = final[ch] + (contrib * scalar(light["color"][ch])) * inten
    gamma = float(np.float32(1.0 / 2.2))
    rgb = [torch.round(torch.clamp(f, 0.0, 1.0) ** gamma * 255.0)
           for f in final]
    return torch.stack(rgb, dim=1).to(torch.uint8)


def render(scene, view_position, view_proj, lights, width, height, *,
           cell=8, dtype=torch.float32, budget=1 << 23):
    """One (H, W, 4) u8 RGBA frame of ``scene`` from the pose's
    ``view_position`` (4,) and ``view_proj`` (4, 4), lit by ``lights``
    ([{"position", "color", "intensity"}]), on the scene's device."""
    screen = _screen(scene, view_proj, width, height, dtype)
    v, x0, y0, cw, ch = _setup(scene, screen, width, height, cell)
    zbuf = _resolve(scene, v, x0, y0, cw, ch, width, height, dtype, budget)
    frame = torch.zeros((height * width, 4), dtype=torch.uint8,
                        device=scene.device)
    frame[:, 2] = 255
    frame[:, 3] = 255
    pix = torch.nonzero(zbuf != NO_HIT).flatten()
    if pix.numel():
        t = zbuf[pix] & TRI_MASK
        frame[pix, :3] = _shade(scene, v, t, pix % width, pix // width,
                                view_position, lights, dtype)
    return frame.reshape(height, width, 4)
