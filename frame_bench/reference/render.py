"""The plain reference: a frame rendered with nothing but PyTorch
operations, on any device, to hold the program's frames against.

It follows the port's NumPy oracle (``golden/rasterizer.py``, the plain
emulation of the reference renderer's four WGSL stages) operation for
operation in the base shading the configurations use, vectorised over
triangles and pixels instead of looping over triangles:

1. vertex: ``(m0*x + m1*y) + (m2*z + m3)`` per clip row, then the screen
   mapping (binning.wgsl:163-189);
2. setup: a triangle with a vertex behind the eye (w < 0), off screen,
   not finite or facing away (cross_z >= 0) is dropped; its bounding box
   is clipped to the frame and widened to whole ``cell`` x ``cell`` cells
   (binning.wgsl:93-142);
3. raster: each pixel sample (integer coordinates) of the cells is tested
   with the cross-product barycentrics (rasteriser.wgsl:71-81), all three
   >= 0 and a finite depth; the nearest depth wins by the u32 order of the
   float's bits, ties to the lower triangle index (the oracle's
   deterministic resolve). Only the samples within a pixel of the
   bounding box are tested: a sample further out is outside the triangle
   by at least that pixel, far beyond rounding;
4. fragment: ambient 0.1 plus each light's Lambert and 0.5 Phong^32
   terms (world-space light direction, the interpolated normal not
   renormalised), clamped, gamma 1/2.2, rounded half to even; the
   background blue (fragment.wgsl:50-93).

A scene with a Kd a face (the material extension) scales the ambient and
each Lambert term by the winner's Kd; one with images (the texture
extension) first multiplies that Kd by the winner's image sampled at its
interpolated uv, repeat-wrapped, by ``tex_filter``: ``nearest``,
``bilinear``, or over the image's box-filtered mip chain ``trilinear``
(the level from the triangle's constant screen-space uv gradient) or
``anisotropic`` (4 such taps along the footprint's major axis), as the
oracle's texture pass does. The mip chains are built here from the
images (a frozen copy of the port's ``io/textures.build_mips``).

The depth resolve is one ``scatter_reduce`` (amin) of (key << 24 |
triangle) over the pixels, so a scene holds at most 2^24 triangles.
Triangles go through in blocks of at most ``budget`` tested samples, so
a million-triangle frame fits in a few hundred MiB. ``dtype`` is the
precision of every floating-point step: float32 as the configurations
state, or a lower one for the control.

Imports nothing of the program and takes nothing it made: the geometry
comes from ``geometry.py``, the matrices from ``camera.py``.
"""

from __future__ import annotations

import numpy as np
import torch

TRI_BITS = 24
TRI_MASK = (1 << TRI_BITS) - 1
NO_HIT = (0xFFFFFFFF << TRI_BITS) | TRI_MASK


FILTERS = ("nearest", "bilinear", "trilinear", "anisotropic")
# Taps of the anisotropic filter (the port's core/maths.py MAX_ANISO).
MAX_ANISO = 4


class Scene:
    """The geometry on ``device``: positions and normals (N, 3) float32
    and the triangles' vertex indices (T, 3) int64; for the material
    extension ``face_kd`` (T, 3) float32, and for the texture extension
    also ``uvs`` (N, 2) float32, ``face_image`` (T,) (-1: none) and
    ``images``, a list of (h, w, 3) float32 in [0, 1], top row first."""

    def __init__(self, positions, normals, indices, device, *, uvs=None,
                 face_kd=None, face_image=None, images=None):
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
        self.face_kd = self.face_image = None
        if face_kd is not None:
            self.face_kd = self._put(face_kd, np.float32)
        if images:
            self.uvs = self._put(uvs, np.float32)
            self.face_image = self._put(face_image, np.int64)
            pool, table = build_mips(images)
            self.pool = self._put(pool, np.float32)
            self.mips = self._put(table, np.int64)

    def _put(self, array, dtype):
        return torch.as_tensor(np.ascontiguousarray(array, dtype),
                               device=self.device)


def build_mips(images):
    """The images' flat pool with each one's box-filtered mip chain
    appended, and the (M, L, 3) table of each level's {offset, width,
    height} (a short chain repeats its 1x1 tail): level l+1 halves each
    side (floor, at least 1), each texel the mean, in float64 rounded to
    float32, of a 2x2 block of level l (a side already at 1 repeats its
    texel; an odd side's last row or column is dropped)."""
    chains = []
    for img in images:
        img = np.asarray(img, np.float32)
        levels = [img]
        while img.shape[0] > 1 or img.shape[1] > 1:
            h2 = max(img.shape[0] // 2, 1)
            w2 = max(img.shape[1] // 2, 1)
            ys = np.minimum(2 * np.arange(h2)[:, None] + np.arange(2),
                            img.shape[0] - 1)
            xs = np.minimum(2 * np.arange(w2)[:, None] + np.arange(2),
                            img.shape[1] - 1)
            block = img[ys[:, None, :, None], xs[None, :, None, :]]
            img = block.mean(axis=(2, 3), dtype=np.float64).astype(np.float32)
            levels.append(img)
        chains.append(levels)
    # Level 0 of every image first, back to back; then the other levels.
    rows = [c[0].reshape(-1, 3) for c in chains]
    offset = sum(r.shape[0] for r in rows)
    L = max(len(c) for c in chains)
    table = np.zeros((len(chains), L, 3), np.int64)
    level0 = 0
    for k, levels in enumerate(chains):
        h, w = levels[0].shape[:2]
        table[k, 0] = (level0, w, h)
        level0 += h * w
        for li, img in enumerate(levels[1:], start=1):
            h, w = img.shape[:2]
            table[k, li] = (offset, w, h)
            rows.append(img.reshape(-1, 3))
            offset += h * w
        for li in range(len(levels), L):
            table[k, li] = table[k, li - 1]
    return np.concatenate(rows), table


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


def _shade(scene, v, t, px, py, vpos, lights, dtype, tex_filter):
    """(n, 3) u8 colours of the winning samples (triangle ``t`` at pixel
    (``px``, ``py``))."""
    dev = scene.device
    vk = [(a[t], b[t], c[t]) for a, b, c in v]
    b1, b2, b3 = _barycentric(vk, px.to(dtype), py.to(dtype))
    idx = scene.tri[t]

    def interp(src, channels=3):
        s = src.to(dtype)
        a, b, c = s[idx[:, 0]], s[idx[:, 1]], s[idx[:, 2]]
        return [b1 * a[:, ch] + b2 * b[:, ch] + b3 * c[:, ch]
                for ch in range(channels)]

    nx, ny, nz = interp(scene.normals)
    wx, wy, wz = interp(scene.positions)

    def scalar(x):
        return torch.tensor(float(np.float32(x)), dtype=dtype, device=dev)

    zero = torch.zeros((), dtype=dtype, device=dev)
    kd = None
    if scene.face_kd is not None:
        kd = scene.face_kd[t].to(dtype)
        if scene.face_image is not None:
            kd = _textured(scene, vk, t, idx, interp(scene.uvs, 2), kd,
                           dtype, tex_filter)
    if kd is None:
        final = [torch.full_like(nx, 0.1) for _ in range(3)]
    else:
        final = [0.1 * kd[:, ch] for ch in range(3)]
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
        inten = scalar(light["intensity"])
        if kd is None:
            contrib = diff + (s16 * s16) * 0.5
            for ch in range(3):
                final[ch] = (final[ch]
                             + (contrib * scalar(light["color"][ch])) * inten)
        else:
            spec = (s16 * s16) * 0.5
            for ch in range(3):
                contrib = diff * kd[:, ch] + spec
                final[ch] = (final[ch]
                             + (contrib * scalar(light["color"][ch])) * inten)
    gamma = float(np.float32(1.0 / 2.2))
    rgb = [torch.round(torch.clamp(f, 0.0, 1.0) ** gamma * 255.0)
           for f in final]
    return torch.stack(rgb, dim=1).to(torch.uint8)


def _textured(scene, vk, t, idx, uv, kd, dtype, tex_filter):
    """The winners' Kd times their image's sample at ``uv`` (those with
    an image): the oracle's texture pass, op for op."""
    u, v = uv
    img = scene.face_image[t]
    has = img >= 0
    mips = scene.mips[img.clamp(min=0)]  # (n, L, 3)
    L = mips.shape[1]
    pool = scene.pool.to(dtype)
    one = torch.ones((), dtype=dtype, device=scene.device)

    def frac(x):
        return x - torch.floor(x)

    def bilinear(row, fu, fv):
        off, tw, th = row[:, 0], row[:, 1], row[:, 2]
        pu = fu * tw.to(dtype) - 0.5
        pv = fv * th.to(dtype) - 0.5
        x0f = torch.floor(pu)
        y0f = torch.floor(pv)
        wx = (pu - x0f)[:, None]
        wy = (pv - y0f)[:, None]
        x0 = torch.remainder(x0f.long(), tw)
        y0 = torch.remainder(y0f.long(), th)
        x1 = torch.remainder(x0 + 1, tw)
        y1 = torch.remainder(y0 + 1, th)

        def fetch(i):
            return pool[torch.where(has, i, 0)]

        t00 = fetch(off + y0 * tw + x0)
        t10 = fetch(off + y0 * tw + x1)
        t01 = fetch(off + y1 * tw + x0)
        t11 = fetch(off + y1 * tw + x1)
        top = t00 * (one - wx) + t10 * wx
        bot = t01 * (one - wx) + t11 * wx
        return top * (one - wy) + bot * wy

    level0 = mips[:, 0]
    if tex_filter == "nearest":
        off, tw, th = level0[:, 0], level0[:, 1], level0[:, 2]
        tx = torch.minimum((frac(u) * tw.to(dtype)).long(), tw - 1)
        ty = torch.minimum((frac(v) * th.to(dtype)).long(), th - 1)
        texel = pool[torch.where(has, off + ty * tw + tx, 0)]
    elif tex_filter == "bilinear":
        texel = bilinear(level0, frac(u), frac(v))
    else:
        # The triangle's constant screen-space uv gradient
        # (common.uv_gradients), the level of detail from its footprint.
        (v1x, v1y, _), (v2x, v2y, _), (v3x, v3y, _) = vk
        uz = (v3x - v1x) * (v2y - v1y) - (v2x - v1x) * (v3y - v1y)
        inv = torch.where(uz.abs() > 1e-20, 1.0 / uz, torch.zeros_like(uz))
        uvs = scene.uvs.to(dtype)
        c1, c2, c3 = uvs[idx[:, 0]], uvs[idx[:, 1]], uvs[idx[:, 2]]
        e2 = c2 - c1
        e3 = c3 - c1
        gx = (e2 * (-(v3y - v1y) * inv)[:, None]
              + e3 * ((v2y - v1y) * inv)[:, None])
        gy = (e2 * ((v3x - v1x) * inv)[:, None]
              + e3 * (-(v2x - v1x) * inv)[:, None])
        tw0 = level0[:, 1].to(dtype)
        th0 = level0[:, 2].to(dtype)
        ax, ay = gx[:, 0] * tw0, gx[:, 1] * th0
        bx, by = gy[:, 0] * tw0, gy[:, 1] * th0
        rx = torch.sqrt(ax * ax + ay * ay)
        ry = torch.sqrt(bx * bx + by * by)
        tiny = torch.full_like(rx, 1e-12)
        top = float(L - 1)
        if tex_filter == "anisotropic":
            pmax = torch.maximum(torch.maximum(rx, ry), tiny)
            pmin = torch.maximum(torch.minimum(rx, ry), tiny)
            n_eff = torch.clamp(pmax / pmin, 1.0, float(MAX_ANISO))
            lod = torch.clamp(torch.log2(pmax / n_eff), 0.0, top)
        else:
            rho = torch.maximum(torch.maximum(rx, ry), tiny)
            lod = torch.clamp(torch.log2(rho), 0.0, top)
        l0 = lod.long()
        l1 = torch.clamp(l0 + 1, max=L - 1)
        f = (lod - l0.to(dtype))[:, None]
        rows = torch.arange(mips.shape[0], device=scene.device)
        row0 = mips[rows, l0]
        row1 = mips[rows, l1]

        def trilinear(fu, fv):
            return (bilinear(row0, fu, fv) * (one - f)
                    + bilinear(row1, fu, fv) * f)

        if tex_filter == "anisotropic":
            x_major = rx >= ry
            mu = torch.where(x_major, gx[:, 0], gy[:, 0])
            mv = torch.where(x_major, gx[:, 1], gy[:, 1])
            spread = one - one / n_eff
            acc = None
            for i in range(MAX_ANISO):
                s_i = (float(np.float32((i + 0.5) / MAX_ANISO))
                       - one * 0.5) * spread
                tap = trilinear(frac(u + mu * s_i), frac(v + mv * s_i))
                acc = tap if acc is None else acc + tap
            texel = acc / float(MAX_ANISO)
        else:
            texel = trilinear(frac(u), frac(v))
    return torch.where(has[:, None], kd * texel, kd)


def render(scene, view_position, view_proj, lights, width, height, *,
           cell=8, dtype=torch.float32, budget=1 << 23, tex_filter="nearest"):
    """One (H, W, 4) u8 RGBA frame of ``scene`` from the pose's
    ``view_position`` (4,) and ``view_proj`` (4, 4), lit by ``lights``
    ([{"position", "color", "intensity"}]), on the scene's device; a
    scene with images samples them by ``tex_filter``."""
    if tex_filter not in FILTERS:
        raise ValueError(f"tex_filter {tex_filter!r}: one of {FILTERS}")
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
                                view_position, lights, dtype, tex_filter)
    return frame.reshape(height, width, 4)
