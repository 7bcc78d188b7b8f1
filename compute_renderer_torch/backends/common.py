"""Shared pipeline stages of the tile path, in torch.

Counterparts of the JAX package's ``backends/common.py`` (the reference's
WGSL device stages):

- ``vertex_stage``   <- geometry_pipeline (binning.wgsl:163-189);
- ``triangle_setup`` <- compute_triangle_meta (binning.wgsl:93-142);
- ``barycentric_coefficients`` / ``affine_combine``: the anchored affine
  form every raster evaluates (rasteriser.wgsl:71-81, reformulated);
- ``coverage_thresholds`` <- the voxelize / edge-melt inside tests
  (rasteriser.wgsl:127-145);
- ``depth_key`` <- the bitcast-u32 depth comparison (rasteriser.wgsl:84-90);
- ``light_terms`` <- the per-light Lambert and Phong terms of
  fragment.wgsl:50-93, in the kernels' op order (shared by the twins'
  epilogues and ``shade``);
- the fused texture tails (``fused_texture_tail``,
  ``fused_texture_tail_mip``) and the deferred one (``resolve_attributes``,
  ``textured_shade``), with one mip sampler ``_sample_mip_px`` shared by
  the fused and the deferred tail;
- ``merge_scratch``: the exact span merge's state, which both rasters
  (``csrc/micro.cu``, ``csrc/raster.cu``) share.

Every expression keeps the JAX package's operation order and association.
Eager torch runs one op per kernel, so nothing is contracted into an FMA
and the results are the IEEE float32 values of that order — the same
values the hand-written kernels (built with ``-fmad=false``) compute.

Depth keys are carried as int64 holding the u32 bit pattern: torch has no
``<``/``minimum`` for ``torch.uint32`` on the CPU. They become ``uint32``
only at the public boundary (``render_frame``'s outputs).

The stages of a frame are safe to capture in a CUDA graph (the renderer
replays one a frame): none reads a value back to the host, and constants
are made on the device (``torch.full``, ``fill_``), never copied from
host memory (an indexed assignment of a Python number is such a copy).
"""

from __future__ import annotations

import numpy as np
import torch

from compute_renderer_torch.core.effects import (
    EFFECT_EDGE_MELT,
    EFFECT_MIRAGE,
    EFFECT_VOXELIZE,
    EFFECT_WAVE,
)
from compute_renderer_torch.core.maths import MAX_ANISO

F32 = torch.float32
DEPTH_CLEAR = 0xFFFFFFFF  # cleared depth key (u32 bit pattern)
BACKGROUND_RGBA = 0xFFFF0000  # blue, alpha 1 (fragment.wgsl:58-62)
NO_TRI = -1  # winner id of a pixel no triangle covers (the tile raster's vis)
# The span merge's words and counters, per (device, Hp, Wp): each launch
# leaves them clear for the next.
_MERGE_SCRATCH: dict = {}


def merge_scratch(device, height_padded, width_padded):
    """The span-merge state of a padded frame size on a device: one int64
    word a pixel, all ones, and one int32 counter a pixel, zero — made
    once and left clear by every launch. A raster that cuts a list into
    spans folds each span's (key, position) words into the words by 64-bit
    atomicMin and counts the spans that arrived: the micro raster
    (``micro.raster_shade_micro``) a word a pixel in 8x8 cells and a
    counter a cell, the tile raster (``raster.raster_shade_tiles``, flat
    layout) a word a pixel tile by tile and a counter a (tile,
    sub-rectangle). Both use the same buffers, so at most one frame of a
    (device, Hp, Wp) may be in flight at once: the renderer runs its
    frames on one stream, one after another. Made eagerly: the renderer
    runs an eager frame before it captures one in a CUDA graph, so that a
    graph reads these buffers and never makes them (a buffer made inside
    a capture would come from the graph's pool, filled only at replay)."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    k = (index, height_padded, width_padded)
    if k not in _MERGE_SCRATCH:
        pixels = height_padded * width_padded
        _MERGE_SCRATCH[k] = (
            torch.full((pixels,), -1, dtype=torch.int64, device=device),
            torch.zeros((pixels,), dtype=torch.int32, device=device))
    return _MERGE_SCRATCH[k]


def empty_frame(width: int, height: int, device):
    """Background-only frame for zero-triangle scenes: blue clear color +
    cleared depth (fragment.wgsl:58-62)."""
    rgba = torch.full((height, width, 4), 255, dtype=torch.uint8,
                      device=device)
    rgba[..., :2].fill_(0)
    key = torch.full((height, width), -1, dtype=torch.int32,
                     device=device).view(torch.uint32)
    return rgba, key


# ---------------------------------------------------------------------------
# Stage 1: vertex processing
# ---------------------------------------------------------------------------

def apply_wave_effect(pos, effect):
    """Wave vertex displacement (binning.wgsl:144-161), branchless.

    ``pos`` (N, 3) f32; ``effect`` (6,) f32 [type, p1..p4, time]. Applied
    only when type == 1."""
    amplitude, frequency, phase, direction = (
        effect[1], effect[2], effect[3], effect[4],
    )
    x, y, z = pos[:, 0], pos[:, 1], pos[:, 2]
    dy = amplitude * torch.sin(frequency * x + phase)
    dx = amplitude * torch.sin(frequency * y + phase)
    dist = torch.sqrt(x * x + y * y)
    dz = amplitude * torch.sin(frequency * dist + phase)

    is_wave = effect[0] == EFFECT_WAVE
    vertical = direction < 0.5
    horizontal = (direction >= 0.5) & (direction < 1.5)
    return torch.stack(
        [
            torch.where(is_wave & horizontal, x + dx, x),
            torch.where(is_wave & vertical, y + dy, y),
            torch.where(is_wave & ~(vertical | horizontal), z + dz, z),
        ],
        dim=1,
    )


def vertex_stage(positions, view_proj, effect, width: int, height: int):
    """Transform vertices to screen space (binning.wgsl:163-189).

    Returns (world (N, 3), screen (N, 4)) with screen =
    (x_px, y_px_flipped, ndc_z, clip_w). The clip-space sums associate as
    ``(m0*x + m1*y) + (m2*z + m3)``, as in the JAX package."""
    positions = positions.to(F32)
    world = apply_wave_effect(positions, effect)

    m = view_proj.to(F32)
    x, y, z = world[:, 0], world[:, 1], world[:, 2]
    cx, cy, cz, cw = (
        (m[r, 0] * x + m[r, 1] * y) + (m[r, 2] * z + m[r, 3])
        for r in range(4)
    )
    ndc_x = cx / cw
    ndc_y = cy / cw
    screen = torch.stack(
        [
            (ndc_x + 1.0) * 0.5 * float(width),
            (1.0 - ndc_y) * 0.5 * float(height),
            cz / cw,
            cw,
        ],
        dim=1,
    )
    return world, screen


# ---------------------------------------------------------------------------
# Stage 2: triangle setup / culling / tile ranges
# ---------------------------------------------------------------------------

def triangle_setup(screen, tri, effect, width: int, height: int,
                   tile_h: int, tile_w: int):
    """Per-triangle cull + clipped bbox + covered-tile rectangle
    (binning.wgsl:93-142). ``tri`` is (T, 3) int vertex indices.

    Returns a dict of (T,) tensors: ``alive`` (bool), ``tile_x0/y0``
    (first covered tile), ``tile_x1/y1`` (exclusive end) and
    ``px_x0/y0/x1/y1`` (the covered pixel rectangle: the union of the
    covered tiles, clipped to the frame), int32."""
    v = screen[tri.long()]  # (T, 3, 4)
    v1x, v1y, v1w = v[:, 0, 0], v[:, 0, 1], v[:, 0, 3]
    v2x, v2y, v2w = v[:, 1, 0], v[:, 1, 1], v[:, 1, 3]
    v3x, v3y, v3w = v[:, 2, 0], v[:, 2, 1], v[:, 2, 3]

    w_ok = ~((v1w < 0.0) | (v2w < 0.0) | (v3w < 0.0))

    # torch.minimum / maximum propagate NaN, like jnp's.
    min_x = torch.minimum(torch.minimum(v1x, v2x), v3x)
    max_x = torch.maximum(torch.maximum(v1x, v2x), v3x)
    min_y = torch.minimum(torch.minimum(v1y, v2y), v3y)
    max_y = torch.maximum(torch.maximum(v1y, v2y), v3y)

    on_screen = ~(
        (max_x < 0.0) | (min_x >= float(width))
        | (max_y < 0.0) | (min_y >= float(height))
    )

    ax = v2x - v1x
    ay = v2y - v1y
    bx = v3x - v1x
    by = v3y - v1y
    cross_z = ax * by - ay * bx
    facing = (effect[0] == EFFECT_VOXELIZE) | (cross_z < 0.0)

    finite = (
        torch.isfinite(v1x) & torch.isfinite(v2x) & torch.isfinite(v3x)
        & torch.isfinite(v1y) & torch.isfinite(v2y) & torch.isfinite(v3y)
    )

    alive = w_ok & on_screen & facing & finite

    zero = torch.zeros((), dtype=F32, device=screen.device)
    cb_min_x = torch.maximum(min_x, zero)
    cb_min_y = torch.maximum(min_y, zero)
    cb_max_x = torch.minimum(max_x, zero + (float(width) - 1.0))
    cb_max_y = torch.minimum(max_y, zero + (float(height) - 1.0))

    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h

    def safe(a):
        return torch.where(alive, a, zero)

    i32 = torch.int32
    tile_x0 = torch.maximum(torch.floor(safe(cb_min_x) / float(tile_w)),
                            zero).to(i32)
    tile_y0 = torch.maximum(torch.floor(safe(cb_min_y) / float(tile_h)),
                            zero).to(i32)
    tile_x1 = torch.minimum(torch.ceil(safe(cb_max_x) / float(tile_w)),
                            zero + float(ntx)).to(i32)
    tile_y1 = torch.minimum(torch.ceil(safe(cb_max_y) / float(tile_h)),
                            zero + float(nty)).to(i32)

    alive = alive & (tile_x1 > tile_x0) & (tile_y1 > tile_y0)
    tile_x1 = torch.where(alive, tile_x1, tile_x0)
    tile_y1 = torch.where(alive, tile_y1, tile_y0)
    return {
        "alive": alive,
        "tile_x0": tile_x0,
        "tile_y0": tile_y0,
        "tile_x1": tile_x1,
        "tile_y1": tile_y1,
        "px_x0": tile_x0 * tile_w,
        "px_y0": tile_y0 * tile_h,
        "px_x1": torch.clamp(tile_x1 * tile_w, max=width),
        "px_y1": torch.clamp(tile_y1 * tile_h, max=height),
    }


# ---------------------------------------------------------------------------
# Stage 3 support: anchored affine coefficients, coverage, depth keys
# ---------------------------------------------------------------------------

def barycentric_coefficients(v1x, v1y, v2x, v2y, v3x, v3y):
    """*Anchored* affine barycentric coefficients:

        bc_i(px, py) = A_i + B_i*dx + C_i*dy,   dx = px - v1x, dy = py - v1y

    with the 1/uz division folded into B/C. Degenerate triangles (uz == 0)
    get inf/NaN coefficients — ``a1 = 1 + 0*inv`` exists to make them NaN
    — and then fail the coverage test. Returns the nine coefficient
    tensors plus the anchor ("ax", "ay")."""
    bux = v2y - v1y
    cux = -(v2x - v1x)
    buy = -(v3y - v1y)
    cuy = v3x - v1x
    uz = (v3x - v1x) * (v2y - v1y) - (v2x - v1x) * (v3y - v1y)
    inv = 1.0 / uz
    zero = torch.zeros_like(inv)
    b3, c3 = bux * inv, cux * inv  # bc3 = ux/uz, ux(anchor) = 0
    b2, c2 = buy * inv, cuy * inv  # bc2 = uy/uz, uy(anchor) = 0
    a1 = torch.ones_like(inv) + zero * inv  # NaN for degenerate uz
    b1 = -(bux + buy) * inv
    c1 = -(cux + cuy) * inv
    return {
        "a1": a1, "b1": b1, "c1": c1,
        "a2": zero * inv, "b2": b2, "c2": c2,
        "a3": zero * inv, "b3": b3, "c3": c3,
        "ax": v1x, "ay": v1y,
    }


def affine_combine(coeffs, w1, w2, w3):
    """(A, B, C) of w1*bc1 + w2*bc2 + w3*bc3 — the affine form of any
    barycentric-interpolated quantity (depth, normals, world positions)."""
    a = w1 * coeffs["a1"] + w2 * coeffs["a2"] + w3 * coeffs["a3"]
    b = w1 * coeffs["b1"] + w2 * coeffs["b2"] + w3 * coeffs["b3"]
    c = w1 * coeffs["c1"] + w2 * coeffs["c2"] + w3 * coeffs["c3"]
    return a, b, c


def coverage_thresholds(effect):
    """Per-frame scalar thresholds for the inside test, as 0-d tensors:
    (threshold, melt_threshold) — -param1 under voxelize (else 0), and the
    edge-melt min-barycentric cutoff (-inf when inactive)."""
    etype = effect[0]
    zero = torch.zeros((), dtype=F32, device=effect.device)
    threshold = torch.where(etype == EFFECT_VOXELIZE, -effect[1], zero)
    melt = effect[1] * (0.5 + 0.5 * torch.sin(effect[5] + effect[2]))
    melt_threshold = torch.where(etype == EFFECT_EDGE_MELT, melt,
                                 zero - float("inf"))
    return threshold, melt_threshold


def depth_key(z):
    """f32 depth -> ordering key: the u32 bit pattern of z (the reference's
    atomic comparison on raw float bits, rasteriser.wgsl:84-90), held in
    int64 so that keys compare unsigned. -0.0 keys as 0x80000000."""
    return z.to(F32).view(torch.int32).to(torch.int64) & 0xFFFFFFFF


def light_terms(normal, world, eye, light_pos):
    """Per light li: (li, Lambert diff, pow32 Phong spec) at world position
    ``world`` = (wx, wy, wz) with the unnormalized normal ``normal`` =
    (nx, ny, nz), all (...)-shaped tensors; ``eye`` (3,) the view
    position, ``light_pos`` (L, >= 3) the lights' rows, position first.
    The kernels' op order (csrc/shade.cuh ``light_terms``): eager torch
    contracts nothing, so these are the kernels' floats."""
    nx, ny, nz = normal
    wx, wy, wz = world
    vdx = eye[0] - wx
    vdy = eye[1] - wy
    vdz = eye[2] - wz
    vnorm = torch.sqrt(vdx * vdx + vdy * vdy + vdz * vdz)
    vdx = vdx / vnorm
    vdy = vdy / vnorm
    vdz = vdz / vnorm
    zero = torch.zeros((), dtype=F32, device=nx.device)
    for li in range(light_pos.shape[0]):
        lp = light_pos[li]
        ldx = lp[0] - wx
        ldy = lp[1] - wy
        ldz = lp[2] - wz
        lnorm = torch.sqrt(ldx * ldx + ldy * ldy + ldz * ldz)
        ldx = ldx / lnorm
        ldy = ldy / lnorm
        ldz = ldz / lnorm
        d = nx * ldx + ny * ldy + nz * ldz
        diff = torch.where(d > 0.0, d, zero)
        # reflect(-l, n) = -l - 2*dot(-l, n)*n (WGSL reflect)
        edotn = -(ldx * nx + ldy * ny + ldz * nz)
        rdx = -ldx - 2.0 * edotn * nx
        rdy = -ldy - 2.0 * edotn * ny
        rdz = -ldz - 2.0 * edotn * nz
        s = vdx * rdx + vdy * rdy + vdz * rdz
        s = torch.where(s > 0.0, s, zero)
        s2 = s * s
        s4 = s2 * s2
        s8 = s4 * s4
        s16 = s8 * s8
        yield li, diff, s16 * s16


# ---------------------------------------------------------------------------
# Deferred texturing: the winner's attributes, resolved after the raster
# ---------------------------------------------------------------------------

def warp_positions(xs, ys, effect):
    """The mirage sample warp on (...)-shaped f32 pixel coordinates
    (rasteriser.wgsl:110-118), in the rasters' op order."""
    amplitude, frequency, phase, time = (effect[1], effect[2], effect[3],
                                         effect[5])
    off_x = amplitude * torch.sin(frequency * xs + time + phase)
    off_y = amplitude * torch.cos(frequency * ys + time + phase)
    is_mirage = effect[0] == EFFECT_MIRAGE
    return (torch.where(is_mirage, xs + off_x, xs),
            torch.where(is_mirage, ys + off_y, ys))


def pixel_grid(effect, width: int, height: int, x_offset: int = 0,
               y_offset: int = 0):
    """(H, W) sample positions, warped under mirage. The offsets place a
    window of the frame (a framebuffer stripe of a sharded render) at its
    global pixel coordinates; integer offsets add exactly in f32."""
    device = effect.device
    xs = (torch.arange(width, dtype=F32, device=device) + x_offset)[
        None, :].expand(height, width)
    ys = (torch.arange(height, dtype=F32, device=device) + y_offset)[
        :, None].expand(height, width)
    return warp_positions(xs, ys, effect)


def resolve_attributes(best_tri, tri, screen, world, normals, uvs, effect,
                       width: int, height: int, x_offset: int = 0,
                       y_offset: int = 0):
    """The winner's interpolated {uv, normal, world_pos} per pixel: its
    barycentrics recomputed from the vertices in the rasters' anchored
    affine form, so each value is the float the raster kernels evaluate
    from the coefficient table.

    ``best_tri`` (H, W) i32 winner or ``NO_TRI``; ``tri`` (T, 3); per
    vertex ``screen`` (N, 4), ``world`` / ``normals`` (N, 3), ``uvs``
    (N, 2); the offsets as ``pixel_grid``'s. Returns a dict of (H, W, c)
    f32 (zeros where uncovered) and 'flag' (H, W) bool."""
    flag = best_tri != NO_TRI
    idx = tri.long()[torch.where(flag, best_tri, 0).long()]  # (H, W, 3)
    corners = [idx[..., k] for k in range(3)]
    v1, v2, v3 = (screen[i] for i in corners)
    px, py = pixel_grid(effect, width, height, x_offset, y_offset)
    co = barycentric_coefficients(v1[..., 0], v1[..., 1], v2[..., 0],
                                  v2[..., 1], v3[..., 0], v3[..., 1])
    dx = px - co["ax"]
    dy = py - co["ay"]

    def interp(src, n):
        w1, w2, w3 = (src[i] for i in corners)
        chans = []
        for ch in range(n):
            a, b, c = affine_combine(co, w1[..., ch], w2[..., ch],
                                     w3[..., ch])
            chans.append(a + b * dx + c * dy)
        return torch.where(flag[..., None], torch.stack(chans, dim=-1), 0.0)

    return {"flag": flag, "uv": interp(uvs.to(F32), 2),
            "normal": interp(normals.to(F32), 3),
            "world_pos": interp(world, 3)}


def shade(gbuffer, view_position, light_world_pos, light_color,
          light_intensity):
    """fragment_main (fragment.wgsl:50-93) on a resolved G-buffer carrying
    the per-pixel diffuse ``kd`` (H, W, 3): ambient 0.1 kd, per light
    (diff kd + 0.5 spec) * color * intensity, clip, gamma 1/2.2, round,
    the blue background. The material epilogue of the fused tails, with
    diff and spec from ``light_terms`` on the resolved attributes.
    Returns (H, W, 4) u8 RGBA."""
    n, w = gbuffer["normal"], gbuffer["world_pos"]
    planes = []
    for _, diff, spec in light_terms(
            (n[..., 0], n[..., 1], n[..., 2]),
            (w[..., 0], w[..., 1], w[..., 2]), view_position.to(F32),
            light_world_pos.to(F32)):
        planes += [diff, spec]
    return _texf_shade_epilogue(gbuffer["kd"], gbuffer["flag"],
                                torch.stack(planes), 0, light_color,
                                light_intensity)


# ---------------------------------------------------------------------------
# Texture sampling: nearest, bilinear and the mip filters
# ---------------------------------------------------------------------------

def _bilinear_level_fetch(fetch, off, tw, th, fu, fv, safe_idx):
    """One bilinear tap at an {offset, width, height} level: GL half-texel
    convention, repeat wrap (``torch.remainder`` takes the divisor's sign,
    as jnp.mod does), the JAX package's lerp order."""
    pu = fu * tw.to(F32) - 0.5
    pv = fv * th.to(F32) - 0.5
    x0f = torch.floor(pu)
    y0f = torch.floor(pv)
    wx = (pu - x0f)[..., None]
    wy = (pv - y0f)[..., None]
    i32 = torch.int32
    x0 = torch.remainder(x0f.to(i32), tw)
    y0 = torch.remainder(y0f.to(i32), th)
    x1 = torch.remainder(x0 + 1, tw)
    y1 = torch.remainder(y0 + 1, th)
    t00 = fetch(safe_idx(off + y0 * tw + x0))
    t10 = fetch(safe_idx(off + y0 * tw + x1))
    t01 = fetch(safe_idx(off + y1 * tw + x0))
    t11 = fetch(safe_idx(off + y1 * tw + x1))
    top = t00 * (1.0 - wx) + t10 * wx
    bot = t01 * (1.0 - wx) + t11 * wx
    return top * (1.0 - wy) + bot * wy


def sample_atlas(texels, tex_table, face_tex, best_tri, flag, uv,
                 bilinear: bool = False):
    """Nearest (default) or bilinear repeat-wrap sample of the flat atlas
    for the deferred tail: ``tex_table`` (M, 3) i32 {offset, width,
    height}, ``face_tex`` (T,) i32 slot per triangle (-1 untextured),
    ``uv`` the resolved (H, W, 2) texcoord. Returns (texel (H, W, 3) f32,
    white where ``has`` is False, has (H, W) bool)."""
    tid = face_tex[torch.where(flag, best_tri, 0).long()]
    has = flag & (tid >= 0)
    t0 = torch.where(has, tid, 0).long()
    off = tex_table[t0, 0]
    tw = tex_table[t0, 1]
    th = tex_table[t0, 2]
    fu = uv[..., 0] - torch.floor(uv[..., 0])
    fv = uv[..., 1] - torch.floor(uv[..., 1])

    def safe_idx(i):
        return torch.where(has, i, 0)

    def fetch(i):
        return texels[i.long()]

    if bilinear:
        texel = _bilinear_level_fetch(fetch, off, tw, th, fu, fv, safe_idx)
    else:
        i32 = torch.int32
        tx = torch.minimum((fu * tw.to(F32)).to(i32), tw - 1)
        ty = torch.minimum((fv * th.to(F32)).to(i32), th - 1)
        texel = fetch(safe_idx(off + ty * tw + tx))
    return torch.where(has[..., None], texel, 1.0), has


def _uv_gradients_comps(v1x, v1y, v2x, v2y, v3x, v3y, e2u, e2v, e3u, e3v):
    """The screen-space uv gradients (T, 4) [du/dx, dv/dx, du/dy, dv/dy]
    from (T,) screen corners and uv edges; degenerate triangles (|uz| <=
    1e-20) get 0 (mip level 0). The JAX package's op order."""
    uz = (v3x - v1x) * (v2y - v1y) - (v2x - v1x) * (v3y - v1y)
    big = torch.abs(uz) > 1e-20
    safe = torch.where(big, uz, 1.0)
    inv = torch.where(big, 1.0 / safe, 0.0)
    db2_dx = -(v3y - v1y) * inv
    db3_dx = (v2y - v1y) * inv
    db2_dy = (v3x - v1x) * inv
    db3_dy = -(v2x - v1x) * inv
    cols = []
    for grad_b2, grad_b3 in ((db2_dx, db3_dx), (db2_dy, db3_dy)):
        for e2, e3 in ((e2u, e3u), (e2v, e3v)):
            cols.append(e2 * grad_b2 + e3 * grad_b3)
    return torch.stack(cols, dim=1)


def uv_gradients(tri, screen, uvs):
    """Per-triangle screen-space uv gradients (T, 4) [du/dx, dv/dx, du/dy,
    dv/dy] from per-vertex ``screen`` (N, 4) and ``uvs`` (N, 2): constant
    per triangle, since the barycentrics are affine in the pixel
    position."""
    tri = tri.long()
    v1, v2, v3 = (screen[tri[:, k]] for k in range(3))
    uv1, uv2, uv3 = (uvs[tri[:, k]].to(F32) for k in range(3))
    e2 = uv2 - uv1
    e3 = uv3 - uv1
    return _uv_gradients_comps(v1[:, 0], v1[:, 1], v2[:, 0], v2[:, 1],
                               v3[:, 0], v3[:, 1], e2[:, 0], e2[:, 1],
                               e3[:, 0], e3[:, 1])


def uv_gradients_soa(screen_soa, uv_c):
    """``uv_gradients`` on corner-SoA inputs: ``screen_soa[k][c]`` the (T,)
    component c of corner k, ``uv_c`` (3, 2, T). The same ops on the same
    floats: bitwise ``uv_gradients`` over the equivalent vertices."""
    v1, v2, v3 = screen_soa
    return _uv_gradients_comps(
        v1[0], v1[1], v2[0], v2[1], v3[0], v3[1],
        uv_c[1][0] - uv_c[0][0], uv_c[1][1] - uv_c[0][1],
        uv_c[2][0] - uv_c[0][0], uv_c[2][1] - uv_c[0][1])


MIP_FILTERS = ("trilinear", "anisotropic")


def mip_tri_rows(face_tex, mip_table, guv, tex_filter: str,
                 max_aniso: int = MAX_ANISO):
    """Per-triangle mip-sampling constants (T, 5) f32 [tid, lod, mu, mv,
    spread], per frame (the gradients follow the screen transform).

    Every input is constant per triangle, so the LOD / footprint formulas
    are evaluated here once: the fused kernels carry these rows as flat
    table columns and the deferred tail gathers them by winner, and both
    sample through ``_sample_mip_px`` on the same floats, which keeps the
    two images bitwise equal. LOD follows the GL footprint rule,
    log2(max(|d(uv)/dx * dims|, |d(uv)/dy * dims|)) clipped to [0, L-1];
    anisotropic divides the major footprint by the tap count n_eff <=
    ``max_aniso`` and spreads the taps along the major axis (mu, mv) over
    ``spread`` = 1 - 1/n_eff."""
    L = mip_table.shape[1]
    tid = face_tex.to(torch.int32)
    base = mip_table[torch.where(tid >= 0, tid, 0).long(), 0]
    tw0 = base[:, 1].to(F32)
    th0 = base[:, 2].to(F32)
    gx_u = guv[:, 0] * tw0
    gx_v = guv[:, 1] * th0
    gy_u = guv[:, 2] * tw0
    gy_v = guv[:, 3] * th0
    tiny = torch.full((), 1e-12, dtype=F32, device=guv.device)
    rx = torch.sqrt(gx_u * gx_u + gx_v * gx_v)
    ry = torch.sqrt(gy_u * gy_u + gy_v * gy_v)
    if tex_filter == "trilinear":
        rho = torch.maximum(torch.maximum(rx, ry), tiny)
        lod = torch.clamp(torch.log2(rho), 0.0, float(L - 1))
        mu = mv = spread = torch.zeros_like(tw0)
    elif tex_filter == "anisotropic":
        pmax = torch.maximum(torch.maximum(rx, ry), tiny)
        pmin = torch.maximum(torch.minimum(rx, ry), tiny)
        n_eff = torch.clamp(pmax / pmin, 1.0, float(max_aniso))
        lod = torch.clamp(torch.log2(pmax / n_eff), 0.0, float(L - 1))
        x_major = rx >= ry
        mu = torch.where(x_major, guv[:, 0], guv[:, 2])
        mv = torch.where(x_major, guv[:, 1], guv[:, 3])
        spread = 1.0 - 1.0 / n_eff
    else:
        raise ValueError(f"mip_tri_rows: not a mip filter: {tex_filter!r}")
    return torch.stack([tid.to(F32), lod, mu, mv, spread], dim=1)


def _sample_mip_px(texels, mip_table, tid, lod, mu, mv, spread, u, v, flag,
                   tex_filter: str, max_aniso: int = MAX_ANISO):
    """The one per-pixel mip sampler, over per-triangle ``mip_tri_rows``
    columns at pixel rank (gathered by winner in the deferred tail, copied
    by the kernels into the TEXF_MIP G-buffer): the fused and the deferred
    tail sample through this function on the same floats.

    Trilinear: two bilinear taps at the levels around lod, lerped by its
    fraction. Anisotropic: ``max_aniso`` such taps along (mu, mv), spread
    over ``spread``, averaged (with zero spread every tap is the centre's
    and the mean is exact). Returns (texel (..., 3), white where ``has``
    is False, has)."""
    has = flag & (tid >= 0)
    t0 = torch.where(has, tid, 0).long()
    # Masked pixels may carry a NaN lod (the deferred tail gathers
    # triangle 0's row there), whose int conversion is undefined in torch:
    # level 0 keeps their gathers in range; their texel is replaced below.
    lod = torch.where(has, lod, 0.0)
    L = mip_table.shape[1]
    l0 = lod.to(torch.int32)
    l1 = torch.clamp(l0 + 1, max=L - 1)
    frac = (lod - l0.to(F32))[..., None]
    row0 = mip_table[t0, l0.long()]
    row1 = mip_table[t0, l1.long()]

    def safe_idx(i):
        return torch.where(has, i, 0)

    def fetch(i):
        return texels[i.long()]

    def tap(ui, vi):
        fu = ui - torch.floor(ui)
        fv = vi - torch.floor(vi)
        return (_bilinear_level_fetch(fetch, row0[..., 0], row0[..., 1],
                                      row0[..., 2], fu, fv, safe_idx)
                * (1.0 - frac)
                + _bilinear_level_fetch(fetch, row1[..., 0], row1[..., 1],
                                        row1[..., 2], fu, fv, safe_idx)
                * frac)

    if tex_filter == "trilinear":
        texel = tap(u, v)
    elif tex_filter == "anisotropic":
        texel = None
        for i in range(max_aniso):
            # An f32 constant, as the JAX package's F32(...) - F32(0.5).
            c = float(np.float32((i + 0.5) / max_aniso) - np.float32(0.5))
            s = c * spread
            t = tap(u + mu * s, v + mv * s)
            texel = t if texel is None else texel + t
        texel = texel / float(max_aniso)
    else:
        raise ValueError(
            f"mip sampler needs trilinear/anisotropic, not {tex_filter!r}")
    return torch.where(has[..., None], texel, 1.0), has


def sample_atlas_mip(texels, mip_table, face_tex, best_tri, flag, uv,
                     guv_rows, tex_filter: str, max_aniso: int = MAX_ANISO):
    """Trilinear / anisotropic sample of the mip-extended atlas for the
    deferred tail: ``mip_table`` (M, L, 3) i32 from ``io.textures.
    build_mips``, ``guv_rows`` the (T, 4) ``uv_gradients``; the
    ``mip_tri_rows`` of the winner feed ``_sample_mip_px``."""
    rows = mip_tri_rows(face_tex, mip_table, guv_rows, tex_filter,
                        max_aniso=max_aniso)
    r = rows[torch.where(flag, best_tri, 0).long()]  # (H, W, 5)
    return _sample_mip_px(texels, mip_table, r[..., 0].to(torch.int32),
                          r[..., 1], r[..., 2], r[..., 3], r[..., 4],
                          uv[..., 0], uv[..., 1], flag, tex_filter,
                          max_aniso=max_aniso)


def textured_shade(gbuffer, best_tri, face_kd, face_tex, texels, tex_table,
                   view_position, light_world_pos, light_color,
                   light_intensity, tex_filter: str = "nearest",
                   tex_mips=None, guv=None):
    """The deferred texture tail after ``resolve_attributes``: the winner's
    kd (ones without materials), the atlas sampled at the resolved uv
    (``sample_atlas``, or ``sample_atlas_mip`` with ``texels`` the
    mip-extended pool, ``tex_mips`` its level table and ``guv`` the (T, 4)
    ``uv_gradients``), kd modulated, then ``shade``. Returns (H, W, 4) u8
    RGBA."""
    flag = gbuffer["flag"]
    if face_kd is not None:
        kd = face_kd.to(F32)[torch.where(flag, best_tri, 0).long()]
        kd = torch.where(flag[..., None], kd, 1.0)
    else:
        kd = torch.ones(flag.shape + (3,), dtype=F32, device=flag.device)
    face_tex = face_tex.to(torch.int32)
    if tex_filter in MIP_FILTERS:
        if tex_mips is None or guv is None:
            raise ValueError(f"tex_filter={tex_filter!r} needs the "
                             "mip-extended pool, tex_mips and guv")
        texel, has = sample_atlas_mip(texels, tex_mips, face_tex, best_tri,
                                      flag, gbuffer["uv"], guv, tex_filter)
    else:
        texel, has = sample_atlas(texels, tex_table, face_tex, best_tri,
                                  flag, gbuffer["uv"],
                                  bilinear=tex_filter == "bilinear")
    gbuffer = dict(gbuffer, kd=torch.where(has[..., None], kd * texel, kd))
    return shade(gbuffer, view_position, light_world_pos, light_color,
                 light_intensity)


# ---------------------------------------------------------------------------
# Fused texturing: the G-buffer the raster kernels' texf mode writes, and
# the tail that samples the atlas and shades it
# ---------------------------------------------------------------------------
#
# G-buffer channels (C, H, W) f32, C = texf_channels(L):
#   0: u      1: v          interpolated texcoord (affine)
#   2: kd.r   3: kd.g   4: kd.b   winner's per-triangle diffuse (1s if none)
#   5: off    6: tw     7: th     winner's TextureInfo row as exact f32
#                                 ints (custom_pipeline/util.rs:75-85);
#                                 tw == 0 marks an untextured face
#   8+2i: diff_i   9+2i: spec_i  per-light Lambert and pow32 Phong scalars,
#                                 the shading epilogue's op chain
TEXF_BASE_CHANNELS = 8
# TextureInfo offsets travel as f32 in the texf table: exact below 2^24.
TEXF_MAX_OFFSET = 1 << 24
# The mip-filtered (TEXF_MIP) G-buffer, written by the kernels' texf_mip
# mode from the 46-column table (kd at 38:41, mip_tri_rows at 41:46):
#   0: u      1: v
#   2: kd.r   3: kd.g   4: kd.b
#   5: tid    the winner's texture slot as an exact f32 int (-1 untextured;
#             the tail indexes the i32 mip table, so no 2^24 bound)
#   6: lod    7: mu   8: mv   9: spread   (mip_tri_rows)
#   10+2i: diff_i   11+2i: spec_i
TEXF_MIP_BASE_CHANNELS = 10


def texf_channels(num_lights: int) -> int:
    return TEXF_BASE_CHANNELS + 2 * num_lights


def texf_mip_channels(num_lights: int) -> int:
    return TEXF_MIP_BASE_CHANNELS + 2 * num_lights


def tex_rows_f32(face_tex, tex_table):
    """Per-triangle TextureInfo rows (off, tw, th) as (T, 3) exact f32 for
    the texf coefficient table; untextured faces (slot -1) become all-zero
    rows (tw == 0 is the tail's 'untextured' mark). Offsets must stay below
    2^24 (``cuda.texf_eligible``)."""
    face_tex = face_tex.to(torch.int32)
    t0 = torch.clamp(face_tex, min=0).long()
    rows = tex_table.to(torch.int32)[t0].to(F32)  # (T, 3)
    return torch.where((face_tex >= 0)[:, None], rows,
                       torch.zeros((), dtype=F32, device=rows.device))


def _pool_fetcher(texels, texels_packed):
    """The fused tail's texel fetch: a (P, 3) f32 row gather, or, with the
    u8-packed (P,) i32 pool (``io.textures.pack_pool_u8``), a one-element
    gather and the unpack k / 255 in f32 — the division the loader made,
    so both fetches give the same floats."""
    if texels_packed is None:
        return lambda idx: texels[idx.long()]

    def fetch(idx):
        p = texels_packed[idx.long()]
        return torch.stack([((p >> s) & 0xFF).to(F32) / 255.0
                            for s in (0, 8, 16)], dim=-1)

    return fetch


def fused_texture_tail(gbuf, best_key, texels, light_color, light_intensity,
                       tex_filter: str = "nearest", texels_packed=None):
    """Shade a texf G-buffer: the texel fetch plus elementwise math.

    ``gbuf`` (C, H, W) f32 in the layout above; ``best_key`` (H, W) u32
    (or int holding the u32 pattern; DEPTH_CLEAR = background);
    ``texels`` (P, 3) f32 flat atlas, or ``texels_packed`` its u8-packed
    pool (``_pool_fetcher``: the same texels). Nearest or bilinear
    repeat-wrap sampling, then the material shading with the winner's kd
    times the texel. Returns (H, W, 4) u8 RGBA. The JAX package's op
    order."""
    if tex_filter not in ("nearest", "bilinear"):
        raise ValueError(
            f"the fused texture tail samples nearest or bilinear, not "
            f"{tex_filter!r} (the mip filters take fused_texture_tail_mip)")
    i32 = torch.int32
    flag = best_key.view(i32) != -1
    u = gbuf[0]
    v = gbuf[1]
    kd = torch.stack([gbuf[2], gbuf[3], gbuf[4]], dim=-1)  # (H, W, 3)
    off = gbuf[5].to(i32)
    tw = gbuf[6].to(i32)
    th = gbuf[7].to(i32)
    has = flag & (tw > 0)
    # Background and untextured lanes carry zeros: size 1 keeps the index
    # math finite; their kd is masked below.
    one_i = torch.ones((), dtype=i32, device=gbuf.device)
    tws = torch.where(has, tw, one_i)
    ths = torch.where(has, th, one_i)
    twf = tws.to(F32)
    thf = ths.to(F32)

    pool_fetch = _pool_fetcher(texels, texels_packed)

    def fetch(idx):
        return pool_fetch(torch.where(has, idx, 0))

    fu = u - torch.floor(u)
    fv = v - torch.floor(v)
    if tex_filter == "nearest":
        tx = torch.minimum((fu * twf).to(i32), tws - 1)
        ty = torch.minimum((fv * thf).to(i32), ths - 1)
        texel = fetch(off + ty * tws + tx)
    else:
        pu = fu * twf - 0.5
        pv = fv * thf - 0.5
        x0f = torch.floor(pu)
        y0f = torch.floor(pv)
        wx = (pu - x0f)[..., None]
        wy = (pv - y0f)[..., None]
        x0 = torch.remainder(x0f.to(i32), tws)
        y0 = torch.remainder(y0f.to(i32), ths)
        x1 = torch.remainder(x0 + 1, tws)
        y1 = torch.remainder(y0 + 1, ths)
        t00 = fetch(off + y0 * tws + x0)
        t10 = fetch(off + y0 * tws + x1)
        t01 = fetch(off + y1 * tws + x0)
        t11 = fetch(off + y1 * tws + x1)
        top = t00 * (1.0 - wx) + t10 * wx
        bot = t01 * (1.0 - wx) + t11 * wx
        texel = top * (1.0 - wy) + bot * wy
    kdt = torch.where(has[..., None], kd * texel, kd)
    return _texf_shade_epilogue(kdt, flag, gbuf, TEXF_BASE_CHANNELS,
                                light_color, light_intensity)


def fused_texture_tail_mip(gbuf, best_key, texels, mip_table, light_color,
                           light_intensity, tex_filter: str = "trilinear",
                           max_aniso: int = MAX_ANISO):
    """Shade a TEXF_MIP G-buffer: ``_sample_mip_px`` on the carried tid /
    lod / mu / mv / spread (the deferred tail's sampler on the same
    floats), kd modulated, the material epilogue. ``texels`` is the
    mip-extended pool, ``mip_table`` its (M, L, 3) i32 level table
    (``io.textures.build_mips``). Returns (H, W, 4) u8 RGBA."""
    flag = best_key.view(torch.int32) != -1
    kd = torch.stack([gbuf[2], gbuf[3], gbuf[4]], dim=-1)
    texel, has = _sample_mip_px(
        texels, mip_table, gbuf[5].to(torch.int32), gbuf[6], gbuf[7],
        gbuf[8], gbuf[9], gbuf[0], gbuf[1], flag, tex_filter,
        max_aniso=max_aniso)
    kdt = torch.where(has[..., None], kd * texel, kd)
    return _texf_shade_epilogue(kdt, flag, gbuf, TEXF_MIP_BASE_CHANNELS,
                                light_color, light_intensity)


def _texf_shade_epilogue(kdt, flag, gbuf, base, light_color,
                         light_intensity):
    """The material shading with the per-light diff/spec read from the
    G-buffer (channels ``base``..): ambient 0.1 kd, per light
    (diff kd + 0.5 spec) * color * intensity, clip, gamma, round."""
    final = 0.1 * kdt
    num_lights = (gbuf.shape[0] - base) // 2
    for li in range(num_lights):
        diff = gbuf[base + 2 * li]
        spec = gbuf[base + 2 * li + 1]
        contrib = diff[..., None] * kdt + (spec * 0.5)[..., None]
        final = final + contrib * light_color[li].to(F32) \
            * light_intensity[li].to(F32)
    final = torch.clamp(final, 0.0, 1.0)
    gamma = torch.full((), 1.0 / 2.2, dtype=F32, device=final.device)
    shaded = torch.round(torch.pow(final, gamma) * 255.0).to(torch.uint8)
    background = torch.zeros((3,), dtype=torch.uint8, device=final.device)
    background[2:].fill_(255)
    rgb = torch.where(flag[..., None], shaded, background)
    alpha = torch.full(flag.shape + (1,), 255, dtype=torch.uint8,
                       device=final.device)
    return torch.cat([rgb, alpha], dim=-1)
