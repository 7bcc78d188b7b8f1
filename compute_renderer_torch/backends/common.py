"""Shared pipeline stages of the tile path, in torch.

Counterparts of the JAX package's ``backends/common.py`` (the reference's
WGSL device stages):

- ``vertex_stage``   <- geometry_pipeline (binning.wgsl:163-189);
- ``triangle_setup`` <- compute_triangle_meta (binning.wgsl:93-142);
- ``barycentric_coefficients`` / ``affine_combine``: the anchored affine
  form every raster evaluates (rasteriser.wgsl:71-81, reformulated);
- ``coverage_thresholds`` <- the voxelize / edge-melt inside tests
  (rasteriser.wgsl:127-145);
- ``depth_key`` <- the bitcast-u32 depth comparison (rasteriser.wgsl:84-90).

Every expression keeps the JAX package's operation order and association.
Eager torch runs one op per kernel, so nothing is contracted into an FMA
and the results are the IEEE float32 values of that order — the same
values the hand-written kernels (built with ``-fmad=false``) compute.

Depth keys are carried as int64 holding the u32 bit pattern: torch has no
``<``/``minimum`` for ``torch.uint32`` on the CPU. They become ``uint32``
only at the public boundary (``render_frame``'s outputs).
"""

from __future__ import annotations

import torch

from compute_renderer_torch.core.effects import (
    EFFECT_EDGE_MELT,
    EFFECT_VOXELIZE,
    EFFECT_WAVE,
)

F32 = torch.float32
DEPTH_CLEAR = 0xFFFFFFFF  # cleared depth key (u32 bit pattern)
BACKGROUND_RGBA = 0xFFFF0000  # blue, alpha 1 (fragment.wgsl:58-62)


def empty_frame(width: int, height: int, device):
    """Background-only frame for zero-triangle scenes: blue clear color +
    cleared depth (fragment.wgsl:58-62)."""
    rgba = torch.tensor([0, 0, 255, 255], dtype=torch.uint8,
                        device=device).expand(height, width, 4).contiguous()
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
    (first covered tile), ``tile_x1/y1`` (exclusive end), int32."""
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


def texf_channels(num_lights: int) -> int:
    return TEXF_BASE_CHANNELS + 2 * num_lights


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


def fused_texture_tail(gbuf, best_key, texels, light_color, light_intensity,
                       tex_filter: str = "nearest"):
    """Shade a texf G-buffer: the texel fetch plus elementwise math.

    ``gbuf`` (C, H, W) f32 in the layout above; ``best_key`` (H, W) u32
    (or int holding the u32 pattern; DEPTH_CLEAR = background);
    ``texels`` (P, 3) f32 flat atlas. Nearest or bilinear repeat-wrap
    sampling, then the material shading with the winner's kd times the
    texel. Returns (H, W, 4) u8 RGBA. The JAX package's op order."""
    if tex_filter not in ("nearest", "bilinear"):
        raise NotImplementedError(
            f"the fused texture tail samples nearest or bilinear, not "
            f"{tex_filter!r}; mip filters (TEXF_MIP) are not ported yet "
            "(ROADMAP queue 2)")
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

    def fetch(idx):
        return texels[torch.where(has, idx, 0).long()]

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
    gamma = torch.tensor(1.0 / 2.2, dtype=F32, device=final.device)
    shaded = torch.round(torch.pow(final, gamma) * 255.0).to(torch.uint8)
    background = torch.tensor([0, 0, 255], dtype=torch.uint8,
                              device=final.device)
    rgb = torch.where(flag[..., None], shaded, background)
    alpha = torch.full(flag.shape + (1,), 255, dtype=torch.uint8,
                       device=final.device)
    return torch.cat([rgb, alpha], dim=-1)
