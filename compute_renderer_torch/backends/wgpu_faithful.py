"""Software model of the reference's wgpu HARDWARE pipeline, in torch.

Counterpart of the JAX package's ``backends/wgpu_faithful.py``. The
reference ships two pipelines: the custom compute rasterizer (which
``backends/cuda.py`` and ``backends/xla.py`` rebuild, quirks included)
and a plain wgpu render pipeline used as its visual baseline
(src/wgpu_pipeline/renderer.rs, shaders.wgsl). This module models the
hardware pipeline's semantics:

- no effects: the wgpu vertex shader passes geometry through untouched
  (shaders.wgsl:34-44);
- back-face culling of clockwise triangles, FrontFace::Ccw in NDC
  (renderer.rs:205-207);
- near-plane clipping: triangles crossing z_clip = 0 are clipped into up
  to two sub-triangles, the varyings (world position, normal)
  interpolated linearly in clip space (``_clip_near``; slot t holds the
  primary triangle of input t, slot T + t the second one of a clipped
  quad, so the shapes are static at 2T);
- hardware sample rules: coverage at pixel centers (x + 0.5, y + 0.5)
  with the top-left fill rule, edge functions evaluated
  direction-canonically (watertight shared edges);
- perspective-correct interpolation of the normal and world position;
- float depth, compare Less against the clear 1.0 (renderer.rs:211-215),
  NDC z affine in screen space; ``depth_format="unorm24"`` quantizes it
  to 24-bit unorm before the compare;
- the fragment lighting of shaders.wgsl:46-63 (ambient 0.1, raw normal,
  world-space lights, pow(spec, 32) x 0.5), then the sRGB encode of the
  Bgra8UnormSrgb surface; clear color (0, 0, 255).

Materials and textures do not exist here (the reference's hardware
pipeline has none). The far plane clips per pixel (z > 1 fails the depth
range). Plain torch ops, run eagerly; the pixel work is grouped into
windowed steps as in ``xla.py`` (``xla.window_groups``), each live
sub-triangle tested over its screen bbox widened by one pixel, and the
(depth, slot) minimum carried in one int64 per pixel, so the frame is
the same bit for bit at every ``chunk``.
"""

from __future__ import annotations

import numpy as np
import torch

from compute_renderer_torch.backends import xla
from compute_renderer_torch.backends.common import F32

DEPTH_CLEAR = 1.0
DEPTH_FORMATS = ("float32", "unorm24")


def _srgb_encode(c):
    """Linear -> sRGB transfer function (the Bgra8UnormSrgb surface's
    encode, per the WebGPU/sRGB spec); input clamped to [0, 1]."""
    c = torch.clamp(c, 0.0, 1.0)
    lo = c * 12.92
    gamma = torch.full((), 1.0 / 2.4, dtype=F32, device=c.device)
    hi = 1.055 * torch.pow(c, gamma) - 0.055
    return torch.where(c <= 0.0031308, lo, hi)


def _clip_near(ccl, cattr):
    """Fixed-function near-plane clip of every triangle against z_clip = 0.

    ``ccl``: (T, 3, 4) per-corner clip-space positions; ``cattr``:
    (T, 3, A) per-corner varyings (world pos, normal). Returns
    (corners_cl (2T, 3, 4), corners_attr (2T, 3, A), emitted (2T,) bool):
    slot t emits the (possibly clipped) primary triangle, slot T + t the
    second triangle of a clipped quad. Varyings interpolate linearly in
    clip space. Winding is preserved (corners rotate cyclically).
    Fully-inside triangles pass through bit-identically (gathered, never
    lerped)."""
    V = torch.cat([ccl.to(F32), cattr.to(F32)], dim=-1)
    z = V[:, :, 2]
    inside = z >= 0.0
    count = inside.sum(dim=-1).to(torch.int32)  # (T,)

    # Canonical rotation: one inside -> that vertex first; two inside ->
    # the outside vertex first; otherwise identity. argmax of a bool row
    # is its first True.
    r1 = torch.argmax(inside.to(torch.uint8), dim=-1).to(torch.int32)
    r2 = torch.argmax((~inside).to(torch.uint8), dim=-1).to(torch.int32)
    zero = torch.zeros_like(r1)
    r = torch.where(count == 1, r1, torch.where(count == 2, r2, zero))
    rot = (r[:, None] + torch.arange(3, dtype=torch.int32,
                                     device=r.device)[None, :]) % 3
    Vr = torch.take_along_dim(V, rot[..., None].long(), dim=1)
    A, B, C = Vr[:, 0], Vr[:, 1], Vr[:, 2]  # (T, 4+A)
    zA, zB, zC = A[:, 2], B[:, 2], C[:, 2]

    def isect(P, Q, zP, zQ):
        # Segment P<->Q against z = 0, evaluated from the inside endpoint
        # toward the outside one, so two triangles sharing a clipped edge
        # get the bitwise-same point.
        swap = zP < 0.0
        Pi = torch.where(swap[:, None], Q, P)
        Qi = torch.where(swap[:, None], P, Q)
        zPi = torch.where(swap, zQ, zP)
        zQi = torch.where(swap, zP, zQ)
        d = zPi - zQi
        t = (zPi / torch.where(d == 0.0, torch.ones_like(d), d))[:, None]
        return Pi + t * (Qi - Pi)

    i_ab = isect(A, B, zA, zB)
    i_ac = isect(A, C, zA, zC)

    one = (count == 1)[:, None]
    two = (count == 2)[:, None]
    # count 3: (A, B, C); count 1 (A inside): (A, I_AB, I_AC); count 2
    # (A outside): the quad (I_AB, B, C, I_AC) -> primary (I_AB, B, C).
    c0 = torch.where(two, i_ab, A)
    c1 = torch.where(one, i_ab, B)
    c2 = torch.where(one, i_ac, C)
    tri1 = torch.stack([c0, c1, c2], dim=1)
    # The clipped quad's second triangle: (I_AB, C, I_AC).
    tri2 = torch.stack([i_ab, C, i_ac], dim=1)

    corners = torch.cat([tri1, tri2], dim=0)  # (2T, 3, 4+A)
    emitted = torch.cat([count >= 1, count == 2])
    return corners[:, :, :4], corners[:, :, 4:], emitted


def _pixel_windows(csx, csy, width: int, height: int):
    """Per sub-triangle (x0, x1, y0, y1) int64: its bbox widened by one
    pixel and clipped to the frame, the whole frame where a corner is not
    finite."""
    finite = (torch.isfinite(csx) & torch.isfinite(csy)).all(dim=1)

    def bounds(c, size):
        lo = torch.clamp(c.amin(dim=1), -2.0, size + 2.0)
        hi = torch.clamp(c.amax(dim=1), -2.0, size + 2.0)
        lo = torch.clamp(torch.floor(lo).to(torch.int64) - 1, 0, size)
        hi = torch.clamp(torch.ceil(hi).to(torch.int64) + 1, 0, size)
        full_lo = torch.zeros_like(lo)
        return (torch.where(finite, lo, full_lo),
                torch.where(finite, hi, full_lo + size))

    x0, x1 = bounds(csx, width)
    y0, y1 = bounds(csy, height)
    return x0, x1, y0, y1


def _dot3(a, b):
    """Sum over the last axis of 3, left to right."""
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]
            + a[..., 2] * b[..., 2])


def _normalize(v):
    return v / torch.sqrt(_dot3(v, v))[..., None]


def render_frame(
    positions,
    normals,
    uvs,
    tri,  # (T, 3) int32
    view_proj,
    view_position,
    light_world_pos,
    light_color,
    light_intensity,
    effect,  # accepted for the backend contract; ignored (no effects)
    *,
    width: int,
    height: int,
    chunk: int = xla.DEFAULT_CHUNK,
    depth_format: str = "float32",  # "float32" | "unorm24" (Depth24Plus)
):
    """Render one frame; returns ((H, W, 4) u8 RGBA, depth (H, W) f32)."""
    del effect, uvs  # the wgpu pipeline reads neither
    if depth_format not in DEPTH_FORMATS:
        raise ValueError(f"unknown depth_format {depth_format!r}")
    device = positions.device
    if tri.shape[0] == 0:
        rgba = torch.zeros((height, width, 4), dtype=torch.uint8,
                           device=device)
        rgba[..., 2:].fill_(255)
        return rgba, torch.full((height, width), DEPTH_CLEAR, dtype=F32,
                                device=device)

    positions = positions.to(F32)
    m = view_proj.to(F32)
    x, y, z = positions[:, 0], positions[:, 1], positions[:, 2]
    vclip = torch.stack([
        (m[r, 0] * x + m[r, 1] * y) + (m[r, 2] * z + m[r, 3])
        for r in range(4)
    ], dim=1)  # (N, 4)

    # The near-plane clip over per-triangle corner arrays (the shared
    # vertex layout cannot hold clip-produced vertices).
    tri_i = tri.long()
    ccl, cattr, emitted = _clip_near(
        vclip[tri_i],
        torch.cat([positions[tri_i], normals.to(F32)[tri_i]], dim=-1),
    )
    cpos = cattr[:, :, :3]  # (T2, 3, 3) world position varying
    cnrm = cattr[:, :, 3:6]  # (T2, 3, 3) normal varying

    # Framebuffer coordinates (y down), the WebGPU viewport transform.
    # A corner with w <= 0 after the clip is rejected (degenerate input).
    cw = ccl[:, :, 3]
    wpos_ok = (cw > 0.0).all(dim=1)
    cws = torch.where(cw == 0.0, torch.ones_like(cw), cw)
    csx = (ccl[:, :, 0] / cws + 1.0) * 0.5 * float(width)
    csy = (1.0 - ccl[:, :, 1] / cws) * 0.5 * float(height)
    csz = ccl[:, :, 2] / cws  # NDC depth in [0, 1]
    cinv_w = 1.0 / cws
    T2 = ccl.shape[0]

    # Signed doubled area in framebuffer coords (y down): CCW in NDC is
    # clockwise here, so front faces have area2 < 0; cull the rest.
    x1, y1 = csx[:, 0], csy[:, 0]
    x2, y2 = csx[:, 1], csy[:, 1]
    x3, y3 = csx[:, 2], csy[:, 2]
    area2 = (x2 - x1) * (y3 - y1) - (x3 - x1) * (y2 - y1)
    ids = torch.nonzero(emitted & wpos_ok & (area2 < 0.0)).flatten()

    # Pixel centers.
    pxc = (torch.arange(width, dtype=F32, device=device) + 0.5)[None, :]
    pyc = (torch.arange(height, dtype=F32, device=device) + 0.5)[:, None]
    pxc = pxc.expand(height, width)
    pyc = pyc.expand(height, width)

    lx = [a[ids] for a in (x1, y1, x2, y2, x3, y3)]
    lz = csz[ids]
    larea = area2[ids]
    best = torch.full((height, width), _packed_depth_clear(),
                      dtype=torch.int64, device=device)
    windows = xla.granule_windows(*_pixel_windows(csx[ids], csy[ids], width,
                                                  height),
                                  chunk, width, height)
    for s, e, wx0, wx1, wy0, wy1 in xla.window_groups(windows, chunk,
                                                      int(ids.shape[0])):
        b = lambda a: a[s:e, None, None]
        ax1, ay1, ax2, ay2, ax3, ay3 = (b(a) for a in lx)
        px = pxc[wy0:wy1, wx0:wx1]
        py = pyc[wy0:wy1, wx0:wx1]

        # Edge functions at pixel centers, negated so front interiors are
        # positive, evaluated direction-canonically (endpoints ordered,
        # sign flipped back): triangles sharing an edge see bitwise-negated
        # values of the same float, so exactly one claims each edge pixel.
        def edge(ax, ay, bx_, by_):
            swap = (ax > bx_) | ((ax == bx_) & (ay > by_))
            cax = torch.where(swap, bx_, ax)
            cay = torch.where(swap, by_, ay)
            cbx = torch.where(swap, ax, bx_)
            cby = torch.where(swap, ay, by_)
            e_ = (cby - cay) * (px - cax) - (cbx - cax) * (py - cay)
            return torch.where(swap, -e_, e_)

        e12 = edge(ax1, ay1, ax2, ay2)
        e23 = edge(ax2, ay2, ax3, ay3)
        e31 = edge(ax3, ay3, ax1, ay1)

        # Top-left fill rule: for clockwise (front) triangles in y-down
        # coords an edge (a -> b) is "top" when horizontal pointing left
        # and "left" when pointing down.
        def top_left(ax, ay, bx_, by_):
            dx = bx_ - ax
            dy = by_ - ay
            return (dy > 0.0) | ((dy == 0.0) & (dx < 0.0))

        def covered(e_, tl):
            return (e_ > 0.0) | ((e_ == 0.0) & tl)

        mask = (covered(e12, top_left(ax1, ay1, ax2, ay2))
                & covered(e23, top_left(ax2, ay2, ax3, ay3))
                & covered(e31, top_left(ax3, ay3, ax1, ay1)))

        # Barycentric weights (the edge functions are negated and area2 <
        # 0 for front faces: the signs cancel).
        inv_area = -1.0 / b(larea)
        l1 = e23 * inv_area
        l2 = e31 * inv_area
        l3 = e12 * inv_area
        vz = b(lz)
        zf = l1 * vz[..., 0] + l2 * vz[..., 1] + l3 * vz[..., 2]
        mask &= (zf >= 0.0) & (zf <= 1.0) & torch.isfinite(zf)
        if depth_format == "unorm24":
            scale = float((1 << 24) - 1)
            zf = torch.round(torch.clamp(zf, 0.0, 1.0) * scale) / scale
        # CompareFunction::Less, equal depths to the first-drawn (lower)
        # slot: the (depth, slot) minimum. z + 0.0 maps -0.0 to 0.0, and
        # the bits of a depth in [0, 1] order as the depth.
        bits = (zf + 0.0).view(torch.int32).to(torch.int64)
        packed = torch.where(mask, bits * (1 << 32) + b(ids),
                             xla.PACKED_CLEAR).amin(0)
        view = best[wy0:wy1, wx0:wx1]
        view.copy_(torch.minimum(view, packed))

    # A depth of exactly 1.0 never passes Less against the clear.
    flag = best < _packed_depth_clear()
    high = torch.div(best, 1 << 32, rounding_mode="floor")
    best_z = torch.where(flag, high.to(torch.int32).view(F32),
                         DEPTH_CLEAR)
    tsafe = torch.where(flag, best - high * (1 << 32), 0)
    tsafe = torch.clamp(tsafe, max=T2 - 1)

    # The winner's barycentrics, recomputed once for the attributes.
    vx = csx[tsafe]  # (H, W, 3)
    vy = csy[tsafe]
    e23 = (vx[..., 2] - vx[..., 1]) * (pyc - vy[..., 1]) - (
        vy[..., 2] - vy[..., 1]
    ) * (pxc - vx[..., 1])
    e31 = (vx[..., 0] - vx[..., 2]) * (pyc - vy[..., 2]) - (
        vy[..., 0] - vy[..., 2]
    ) * (pxc - vx[..., 2])
    e12 = (vx[..., 1] - vx[..., 0]) * (pyc - vy[..., 0]) - (
        vy[..., 1] - vy[..., 0]
    ) * (pxc - vx[..., 0])
    area = (vx[..., 1] - vx[..., 0]) * (vy[..., 2] - vy[..., 0]) - (
        vx[..., 2] - vx[..., 0]
    ) * (vy[..., 1] - vy[..., 0])
    inv_area = 1.0 / area
    l1, l2, l3 = e23 * inv_area, e31 * inv_area, e12 * inv_area

    # Perspective-correct interpolation: a/w and 1/w are affine in
    # screen space.
    iw = cinv_w[tsafe]  # (H, W, 3)
    denom = l1 * iw[..., 0] + l2 * iw[..., 1] + l3 * iw[..., 2]

    def persp(attr_corners):  # (T2, 3, 3) -> (H, W, 3)
        av = attr_corners[tsafe]  # (H, W, 3 corners, 3 comps)
        num = (
            l1[..., None] * av[:, :, 0, :] * iw[..., 0:1]
            + l2[..., None] * av[:, :, 1, :] * iw[..., 1:2]
            + l3[..., None] * av[:, :, 2, :] * iw[..., 2:3]
        )
        return num / denom[..., None]

    normal = persp(cnrm)
    wpos = persp(cpos)

    # shaders.wgsl:46-63: ambient 0.1, raw normal, world-space lights.
    color = torch.full(flag.shape + (3,), 0.1, dtype=F32, device=device)
    vp3 = view_position.to(F32)[:3]
    vd = _normalize(vp3 - wpos)
    for li in range(light_world_pos.shape[0]):
        lp = light_world_pos[li].to(F32)
        ld = _normalize(lp - wpos)
        diff = torch.clamp(_dot3(normal, ld), min=0.0)
        # reflect(-light_dir, normal), wgsl reflect(e, n) = e - 2(e.n)n
        edotn = _dot3(-ld, normal)[..., None]
        refl = -ld - 2.0 * edotn * normal
        spec = torch.pow(torch.clamp(_dot3(vd, refl), min=0.0),
                         torch.full((), 32.0, dtype=F32, device=device))
        contrib = diff + spec * 0.5
        color = color + contrib[..., None] * (
            light_color[li].to(F32) * light_intensity[li].to(F32))

    encoded = _srgb_encode(color)
    background = torch.zeros((3,), dtype=F32, device=device)
    background[2:].fill_(1.0)  # linear -> (0, 0, 255)
    out = torch.where(flag[..., None], encoded, background)
    rgba = torch.cat([
        torch.round(out * 255.0).to(torch.uint8),
        torch.full(flag.shape + (1,), 255, dtype=torch.uint8, device=device),
    ], dim=-1)
    return rgba, best_z


def _packed_depth_clear() -> int:
    """The packed (depth, slot) of the cleared depth 1.0 at slot 0: a
    covered depth must pack below it to win."""
    return int(np.float32(DEPTH_CLEAR).view(np.int32)) << 32


def render(mesh, camera_uniform, lights, effect, width, height, *,
           device="cuda", chunk: int = xla.DEFAULT_CHUNK,
           depth_format: str = "float32"):
    """Host-level entry: numpy / dataclasses in, (H, W, 4) u8 numpy out,
    rendered on ``device`` ("cuda", the default, raises without a card;
    "cpu" runs here)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("wgpu_faithful.render(device='cuda') needs an "
                           "NVIDIA GPU with CUDA; pass device='cpu'")

    def dev(a, dtype=F32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    light_world_pos, light_color, light_intensity = lights
    rgba, _ = render_frame(
        dev(mesh.positions), dev(mesh.normals), dev(mesh.uvs),
        dev(mesh.indices.astype(np.int32), torch.int32).reshape(-1, 3),
        dev(camera_uniform.view_proj), dev(camera_uniform.view_position),
        dev(light_world_pos), dev(light_color), dev(light_intensity),
        dev(effect), width=width, height=height, chunk=chunk,
        depth_format=depth_format)
    return rgba.cpu().numpy()
