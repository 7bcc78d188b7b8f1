"""NumPy golden-oracle rasterizer: a direct emulation of the reference's
four-stage custom pipeline.

The port's copy of the JAX package's ``golden/rasterizer.py``, line for
line but for the imports (the port's ``core.effects`` and ``core.maths``).
It stays NumPy on purpose: it is the plain, independent emulation of the
reference's WGSL that the torch twins and the CUDA kernels are held to, so
it must share none of their code.

Stage map (reference file:line):

1. vertex:   wave displacement + view_proj transform + screen mapping
             (binning.wgsl:144-189)
2. setup:    near-plane whole-triangle discard (w < 0), screen-bbox cull,
             backface cull (cross_z >= 0, skipped when effect==voxelize),
             bbox clip, tile range (binning.wgsl:93-142)
3. raster:   per covered-tile-rectangle pixel loop: mirage sample warp
             (rasteriser.wgsl:112-118), barycentric via the cross-product
             formulation (rasteriser.wgsl:71-81), inside test with voxelize
             "inflation" threshold (rasteriser.wgsl:127-134), edge-melt
             min-barycentric discard (rasteriser.wgsl:136-145), interpolated-z
             depth test on *bitcast-u32 ordering* (rasteriser.wgsl:147-185)
4. fragment: blue background, ambient 0.1 + per-light diffuse + Phong
             specular (world-space light dir, unnormalized interpolated
             normal), clamp, gamma 1/2.2 (fragment.wgsl:50-93)

Deliberate divergences from the reference (both documented in SURVEY.md §5):

- depth resolve is deterministic: triangles are processed in index order and
  ties (equal depth key) keep the first writer, where the reference's atomic
  CAS loop is racy;
- non-finite interpolated depths (degenerate triangles reaching the raster
  stage under the voxelize effect) are rejected, where the reference lets
  NaN depth keys win over the cleared depth buffer.
"""

from __future__ import annotations

import numpy as np

from compute_renderer_torch.core.effects import (
    EFFECT_EDGE_MELT,
    EFFECT_MIRAGE,
    EFFECT_VOXELIZE,
    EFFECT_WAVE,
)
from compute_renderer_torch.core.maths import F32, MAX_ANISO

DEPTH_CLEAR_BITS = np.uint32(0xFFFFFFFF)


def apply_wave_effect(pos: np.ndarray, effect: np.ndarray) -> np.ndarray:
    """Vertex wave displacement (binning.wgsl:144-161). pos: (N,3)."""
    amplitude, frequency, phase, direction = (
        F32(effect[1]), F32(effect[2]), F32(effect[3]), F32(effect[4]),
    )
    out = pos.copy()
    if direction < 0.5:  # Vertical
        out[:, 1] += amplitude * np.sin(frequency * pos[:, 0] + phase, dtype=F32)
    elif direction < 1.5:  # Horizontal
        out[:, 0] += amplitude * np.sin(frequency * pos[:, 1] + phase, dtype=F32)
    else:  # Radial
        dist = np.sqrt(pos[:, 0] ** 2 + pos[:, 1] ** 2, dtype=F32)
        out[:, 2] += amplitude * np.sin(frequency * dist + phase, dtype=F32)
    return out.astype(F32)


def vertex_stage(positions, view_proj, effect, width, height):
    """geometry_pipeline over all vertices (binning.wgsl:163-189).

    Returns (world_pos (N,3), screen_pos (N,4)) where screen_pos is
    (x_px, y_px_flipped, ndc_z, clip_w)."""
    positions = positions.astype(F32)
    world_pos = positions
    if int(effect[0]) == EFFECT_WAVE:
        world_pos = apply_wave_effect(world_pos, effect)

    m = view_proj.astype(F32)
    x, y, z = world_pos[:, 0], world_pos[:, 1], world_pos[:, 2]
    # Explicit mul/add chain — identical operation order to
    # backends/common.py vertex_stage, for bitwise agreement per platform.
    cx, cy, cz, w = (
        ((m[r, 0] * x + m[r, 1] * y) + (m[r, 2] * z + m[r, 3])) for r in range(4)
    )
    with np.errstate(divide="ignore", invalid="ignore"):
        screen = np.stack(
            [
                (cx / w + 1.0) * 0.5 * F32(width),
                (1.0 - cy / w) * 0.5 * F32(height),
                cz / w,
                w,
            ],
            axis=1,
        ).astype(F32)
    return world_pos, screen


def triangle_setup(screen, indices, effect, width, height, tile_size):
    """Per-triangle cull + clipped bbox + tile range (binning.wgsl:93-142).

    Returns dict with keys: alive (T,), start_tile (T,2), tile_range (T,2),
    clipped bbox (T,4). Culled triangles have tile_range == 0."""
    tri = indices.reshape(-1, 3)
    v = screen[tri]  # (T, 3, 4)

    w_ok = ~np.any(v[:, :, 3] < 0.0, axis=1)  # near-plane whole-tri discard

    min_x = v[:, :, 0].min(axis=1)
    max_x = v[:, :, 0].max(axis=1)
    min_y = v[:, :, 1].min(axis=1)
    max_y = v[:, :, 1].max(axis=1)

    on_screen = ~(
        (max_x < 0.0) | (min_x >= F32(width)) | (max_y < 0.0) | (min_y >= F32(height))
    )

    # Non-finite screen coords (w == 0 vertices) would wrap the reference's
    # u32 tile arithmetic; we cull them instead (documented divergence).
    finite = np.isfinite(v[:, :, :2]).all(axis=(1, 2))

    ax = v[:, 1, 0] - v[:, 0, 0]
    ay = v[:, 1, 1] - v[:, 0, 1]
    bx = v[:, 2, 0] - v[:, 0, 0]
    by = v[:, 2, 1] - v[:, 0, 1]
    cross_z = ax * by - ay * bx
    is_voxelize = int(effect[0]) == EFFECT_VOXELIZE
    facing = np.ones_like(cross_z, dtype=bool) if is_voxelize else (cross_z < 0.0)

    alive = w_ok & on_screen & facing & finite

    cb_min_x = np.maximum(min_x, 0.0).astype(F32)
    cb_min_y = np.maximum(min_y, 0.0).astype(F32)
    cb_max_x = np.minimum(max_x, F32(width) - 1.0).astype(F32)
    cb_max_y = np.minimum(max_y, F32(height) - 1.0).astype(F32)

    ts = F32(tile_size)
    ntx = (width + tile_size - 1) // tile_size
    nty = (height + tile_size - 1) // tile_size
    start_tx = np.maximum(np.floor(cb_min_x / ts), 0.0).astype(np.int64)
    start_ty = np.maximum(np.floor(cb_min_y / ts), 0.0).astype(np.int64)
    end_tx = np.minimum(np.ceil(cb_max_x / ts), ntx).astype(np.int64)
    end_ty = np.minimum(np.ceil(cb_max_y / ts), nty).astype(np.int64)

    range_x = np.where(alive, end_tx - start_tx, 0)
    range_y = np.where(alive, end_ty - start_ty, 0)

    return {
        "alive": alive & (range_x > 0) & (range_y > 0),
        "start_tile": np.stack([start_tx, start_ty], axis=1),
        "tile_range": np.stack([range_x, range_y], axis=1),
        "bbox": np.stack([cb_min_x, cb_min_y, cb_max_x, cb_max_y], axis=1),
    }


def barycentric(v1, v2, v3, px, py):
    """Cross-product barycentric formulation (rasteriser.wgsl:71-81).

    v1..v3: (4,) screen vertices; px/py: arrays of sample positions.
    Returns (bc1, bc2, bc3) arrays (NaN/inf for degenerate triangles)."""
    ux = (v2[0] - v1[0]) * (v1[1] - py) - (v1[0] - px) * (v2[1] - v1[1])
    uy = (v1[0] - px) * (v3[1] - v1[1]) - (v3[0] - v1[0]) * (v1[1] - py)
    uz = (v3[0] - v1[0]) * (v2[1] - v1[1]) - (v2[0] - v1[0]) * (v3[1] - v1[1])
    with np.errstate(divide="ignore", invalid="ignore"):
        bc2 = uy / uz
        bc3 = ux / uz
        bc1 = 1.0 - (ux + uy) / uz
    return bc1.astype(F32), bc2.astype(F32), bc3.astype(F32)


def depth_key(z: np.ndarray) -> np.ndarray:
    """f32 depth -> u32 ordering key (bitcast, rasteriser.wgsl:84-86).

    Matches the reference's atomic-CAS comparison on raw float bits: for
    positive depths this is the float order; negative depths (closer than the
    near plane) order *after* all positive ones, a reference quirk we keep."""
    return np.ascontiguousarray(z, dtype=F32).view(np.uint32)


def render_golden(
    mesh_positions: np.ndarray,
    mesh_normals: np.ndarray,
    mesh_uvs: np.ndarray,
    indices: np.ndarray,
    view_proj: np.ndarray,
    view_position: np.ndarray,
    light_world_pos: np.ndarray,
    light_color: np.ndarray,
    light_intensity: np.ndarray,
    effect: np.ndarray,
    width: int,
    height: int,
    tile_size: int = 8,
    return_gbuffer: bool = False,
    return_float: bool = False,  # also return pre-quantization (H,W,3) f32
    face_kd: np.ndarray | None = None,  # (T, 3) per-tri diffuse (extension)
    face_tex: np.ndarray | None = None,  # (T,) i32 texture slot (extension)
    texels: np.ndarray | None = None,  # (P, 3) f32 pool (mips appended for trilinear)
    tex_table: np.ndarray | None = None,  # (M, 3) i32 {offset, width, height}
    tex_filter: str = "nearest",  # "nearest" | "bilinear" | "trilinear"
    tex_mips: np.ndarray | None = None,  # (M, L, 3) i32 level table
) -> np.ndarray:
    """Render one frame; returns (H, W, 4) uint8 RGBA.

    ``face_kd`` enables the material extension (per-triangle diffuse
    modulating ambient + diffuse; see backends/common.py ``shade``);
    ``face_tex``/``texels``/``tex_table`` the texture extension (the
    winner's diffuse additionally modulated by a repeat-wrap atlas sample
    at the interpolated uv, nearest or bilinear per ``tex_filter`` — same
    formulas as backends/common.sample_atlas)."""
    effect = np.asarray(effect, dtype=F32)
    world_pos, screen = vertex_stage(
        mesh_positions, view_proj, effect, width, height
    )
    setup = triangle_setup(screen, indices, effect, width, height, tile_size)

    tri = indices.reshape(-1, 3)
    T = tri.shape[0]

    depth = np.full((height, width), DEPTH_CLEAR_BITS, dtype=np.uint32)
    frag_tri = np.full((height, width), -1, dtype=np.int32)
    frag_uv = np.zeros((height, width, 2), dtype=F32)
    frag_normal = np.zeros((height, width, 3), dtype=F32)
    frag_pos = np.zeros((height, width, 3), dtype=F32)
    frag_flag = np.zeros((height, width), dtype=bool)
    frag_kd = (np.ones((height, width, 3), dtype=F32)
               if face_kd is not None or face_tex is not None else None)
    frag_tex = (np.full((height, width), -1, dtype=np.int32)
                if face_tex is not None else None)
    frag_guv = (np.zeros((height, width, 4), dtype=F32)
                if tex_filter in ("trilinear", "anisotropic")
                and face_tex is not None
                else None)

    etype = int(effect[0])
    # Voxelize inflation threshold (rasteriser.wgsl:127-131).
    threshold = F32(-effect[1]) if etype == EFFECT_VOXELIZE else F32(0.0)
    # Edge-melt meltdown threshold (rasteriser.wgsl:136-141).
    if etype == EFFECT_EDGE_MELT:
        melt_thr = F32(effect[1]) * F32(0.5 + 0.5 * np.sin(F32(effect[5]) + F32(effect[2])))
    else:
        melt_thr = None

    for t in range(T):
        if not setup["alive"][t]:
            continue
        stx, sty = setup["start_tile"][t]
        rx, ry = setup["tile_range"][t]
        # Pixel rectangle = union of covered tiles, clipped to screen
        # (rasteriser.wgsl:100-106).
        x0 = int(stx * tile_size)
        x1 = min(int((stx + rx) * tile_size), width)
        y0 = int(sty * tile_size)
        y1 = min(int((sty + ry) * tile_size), height)
        if x1 <= x0 or y1 <= y0:
            continue

        xs = np.arange(x0, x1, dtype=F32)
        ys = np.arange(y0, y1, dtype=F32)
        px, py = np.meshgrid(xs, ys)  # (h, w)

        if etype == EFFECT_MIRAGE:
            px = px + F32(effect[1]) * np.sin(
                F32(effect[2]) * px + F32(effect[5]) + F32(effect[3]), dtype=F32
            )
            py = py + F32(effect[1]) * np.cos(
                F32(effect[2]) * py + F32(effect[5]) + F32(effect[3]), dtype=F32
            )

        i1, i2, i3 = tri[t]
        v1, v2, v3 = screen[i1], screen[i2], screen[i3]
        bc1, bc2, bc3 = barycentric(v1, v2, v3, px, py)

        with np.errstate(invalid="ignore"):
            inside = (bc1 >= threshold) & (bc2 >= threshold) & (bc3 >= threshold)
            if melt_thr is not None:
                min_bc = np.minimum(bc1, np.minimum(bc2, bc3))
                inside &= min_bc >= melt_thr

            z = bc1 * v1[2] + bc2 * v2[2] + bc3 * v3[2]
            inside &= np.isfinite(z)

        if not inside.any():
            continue

        key = depth_key(z)
        region = depth[y0:y1, x0:x1]
        win = inside & (key < region)
        if not win.any():
            continue

        depth[y0:y1, x0:x1] = np.where(win, key, region)

        b1 = bc1[win, None]
        b2 = bc2[win, None]
        b3 = bc3[win, None]
        sel = np.zeros((height, width), dtype=bool)
        sel[y0:y1, x0:x1] = win
        frag_uv[sel] = b1 * mesh_uvs[i1] + b2 * mesh_uvs[i2] + b3 * mesh_uvs[i3]
        frag_normal[sel] = (
            b1 * mesh_normals[i1] + b2 * mesh_normals[i2] + b3 * mesh_normals[i3]
        )
        frag_pos[sel] = b1 * world_pos[i1] + b2 * world_pos[i2] + b3 * world_pos[i3]
        frag_flag[sel] = True
        frag_tri[sel] = t
        if frag_kd is not None and face_kd is not None:
            frag_kd[sel] = face_kd[t].astype(F32)
        if frag_tex is not None:
            frag_tex[sel] = face_tex[t]
        if frag_guv is not None:
            # Per-triangle screen-space uv gradient (constant: affine
            # barycentrics) — same formulas as common.uv_gradients.
            uzg = ((v3[0] - v1[0]) * (v2[1] - v1[1])
                   - (v2[0] - v1[0]) * (v3[1] - v1[1]))
            inv = F32(1.0 / uzg) if abs(uzg) > 1e-20 else F32(0.0)
            e2 = (mesh_uvs[i2] - mesh_uvs[i1]).astype(F32)
            e3 = (mesh_uvs[i3] - mesh_uvs[i1]).astype(F32)
            gx = e2 * F32(-(v3[1] - v1[1]) * inv) + e3 * F32((v2[1] - v1[1]) * inv)
            gy = e2 * F32((v3[0] - v1[0]) * inv) + e3 * F32(-(v2[0] - v1[0]) * inv)
            frag_guv[sel] = np.concatenate([gx, gy]).astype(F32)

    if frag_tex is not None:
        # Texture pass: nearest (default) or bilinear repeat-wrap atlas
        # sample at the winner's uv, multiplied into the per-pixel diffuse
        # (same formulas and lerp order as backends/common.sample_atlas,
        # kept in sync for parity).
        has = frag_flag & (frag_tex >= 0)
        t0 = np.where(has, frag_tex, 0)
        off = tex_table[t0, 0]
        tw = tex_table[t0, 1]
        th = tex_table[t0, 2]
        u = frag_uv[..., 0]
        v = frag_uv[..., 1]
        fu = (u - np.floor(u)).astype(F32)
        fv = (v - np.floor(v)).astype(F32)
        pool = np.asarray(texels, dtype=F32)

        def bilinear_level(off_l, tw_l, th_l):
            # Same math and lerp order as common._bilinear_level.
            pu = (fu * tw_l.astype(F32) - F32(0.5)).astype(F32)
            pv = (fv * th_l.astype(F32) - F32(0.5)).astype(F32)
            x0f = np.floor(pu)
            y0f = np.floor(pv)
            wx = (pu - x0f).astype(F32)[..., None]
            wy = (pv - y0f).astype(F32)[..., None]
            x0 = np.mod(x0f.astype(np.int32), tw_l)
            y0 = np.mod(y0f.astype(np.int32), th_l)
            x1 = np.mod(x0 + 1, tw_l)
            y1 = np.mod(y0 + 1, th_l)
            fetch = lambda i: pool[np.where(has, i, 0)]
            t00 = fetch(off_l + y0 * tw_l + x0)
            t10 = fetch(off_l + y0 * tw_l + x1)
            t01 = fetch(off_l + y1 * tw_l + x0)
            t11 = fetch(off_l + y1 * tw_l + x1)
            one = F32(1.0)
            top = t00 * (one - wx) + t10 * wx
            bot = t01 * (one - wx) + t11 * wx
            return (top * (one - wy) + bot * wy).astype(F32)

        if tex_filter in ("trilinear", "anisotropic"):
            # Mirrors common.mip_tri_rows + _sample_mip_px:
            # GL footprint LOD from the winner triangle's constant uv
            # gradient; two bilinear taps lerped (anisotropic: MAX_ANISO
            # such taps spread along the major footprint axis).
            mips = np.asarray(tex_mips, dtype=np.int32)
            L = mips.shape[1]
            tw0 = tw.astype(F32)
            th0 = th.astype(F32)
            rx = np.sqrt((frag_guv[..., 0] * tw0) ** 2
                         + (frag_guv[..., 1] * th0) ** 2, dtype=F32)
            ry = np.sqrt((frag_guv[..., 2] * tw0) ** 2
                         + (frag_guv[..., 3] * th0) ** 2, dtype=F32)
            if tex_filter == "anisotropic":
                pmax = np.maximum(np.maximum(rx, ry), F32(1e-12))
                pmin = np.maximum(np.minimum(rx, ry), F32(1e-12))
                n_eff = np.clip(pmax / pmin, F32(1.0), F32(MAX_ANISO))
                lod = np.clip(np.log2(pmax / n_eff, dtype=F32),
                              F32(0.0), F32(L - 1))
            else:
                rho = np.maximum(np.maximum(rx, ry), F32(1e-12))
                lod = np.clip(np.log2(rho, dtype=F32), F32(0.0), F32(L - 1))
            l0 = lod.astype(np.int32)
            l1 = np.minimum(l0 + 1, L - 1)
            frac = (lod - l0.astype(F32)).astype(F32)[..., None]
            row0 = mips[t0, l0]
            row1 = mips[t0, l1]

            def trilerp(fu_t, fv_t):
                # Rebind the sample coords the bilinear helper closes over.
                nonlocal fu, fv
                fu_s, fv_s = fu, fv
                fu, fv = fu_t, fv_t
                out = (bilinear_level(row0[..., 0], row0[..., 1],
                                      row0[..., 2]) * (F32(1.0) - frac)
                       + bilinear_level(row1[..., 0], row1[..., 1],
                                        row1[..., 2]) * frac).astype(F32)
                fu, fv = fu_s, fv_s
                return out

            if tex_filter == "anisotropic":
                x_major = rx >= ry
                mu = np.where(x_major, frag_guv[..., 0], frag_guv[..., 2])
                mv = np.where(x_major, frag_guv[..., 1], frag_guv[..., 3])
                spread = (F32(1.0) - F32(1.0) / n_eff).astype(F32)
                acc = None
                for i in range(MAX_ANISO):
                    s_i = (F32((i + 0.5) / MAX_ANISO) - F32(0.5)) * spread
                    ui = (u + mu * s_i).astype(F32)
                    vi = (v + mv * s_i).astype(F32)
                    tap = trilerp((ui - np.floor(ui)).astype(F32),
                                  (vi - np.floor(vi)).astype(F32))
                    acc = tap if acc is None else acc + tap
                texel = (acc / F32(MAX_ANISO)).astype(F32)
            else:
                texel = trilerp(fu, fv)
        elif tex_filter == "bilinear":
            texel = bilinear_level(off, tw, th)
        else:
            tx = np.minimum((fu * tw.astype(F32)).astype(np.int32), tw - 1)
            ty = np.minimum((fv * th.astype(F32)).astype(np.int32), th - 1)
            idx = off + ty * tw + tx
            texel = pool[np.where(has, idx, 0)]
        frag_kd = np.where(has[..., None], frag_kd * texel, frag_kd)

    rgba = shade_fragments(
        frag_flag, frag_normal, frag_pos,
        view_position, light_world_pos, light_color, light_intensity,
        kd=frag_kd, return_float=return_float,
    )
    if return_gbuffer:
        if return_float:
            rgba, fimg = rgba
            return rgba, fimg, {
                "depth_bits": depth,
                "flag": frag_flag,
                "tri": frag_tri,
                "uv": frag_uv,
                "normal": frag_normal,
                "world_pos": frag_pos,
            }
        return rgba, {
            "depth_bits": depth,
            "flag": frag_flag,
            "tri": frag_tri,
            "uv": frag_uv,
            "normal": frag_normal,
            "world_pos": frag_pos,
        }
    return rgba


def shade_fragments(flag, normal, pos, view_position, light_world_pos,
                    light_color, light_intensity, kd=None,
                    return_float: bool = False):
    """Deferred Phong shading pass (fragment.wgsl:50-93).

    Quirks kept from the reference: world-space light direction (the uploaded
    view-space light position is dead code there), interpolated normal NOT
    renormalized, Phong (not Blinn-Phong) with spec * 0.5, pow 32, ambient
    0.1, clamp then gamma 1/2.2, blue background.

    ``kd`` (H,W,3, optional): material-extension per-pixel diffuse —
    modulates ambient + diffuse, same op order as backends/common.shade."""
    H, W = flag.shape
    if kd is None:
        final = np.full((H, W, 3), F32(0.1), dtype=F32)
    else:
        final = (F32(0.1) * kd.astype(F32)).astype(F32)

    eye = np.asarray(view_position, dtype=F32)[:3]
    with np.errstate(invalid="ignore", divide="ignore"):
        for li in range(light_world_pos.shape[0]):
            lp = light_world_pos[li].astype(F32)
            lc = light_color[li].astype(F32)
            inten = F32(light_intensity[li])

            ldir = lp[None, None, :] - pos
            lnorm = np.sqrt((ldir * ldir).sum(-1, keepdims=True), dtype=F32)
            ldir = ldir / lnorm

            # fmax (not maximum): NaN from a zero-length light/view vector
            # yields 0 rather than poisoning the sum, matching GPU max().
            diff = np.fmax((normal * ldir).sum(-1), 0.0)

            vdir = eye[None, None, :] - pos
            vnorm = np.sqrt((vdir * vdir).sum(-1, keepdims=True), dtype=F32)
            vdir = vdir / vnorm

            # reflect(-l, n) = -l - 2*dot(-l, n)*n  (WGSL reflect)
            e = -ldir
            rdir = e - 2.0 * (e * normal).sum(-1, keepdims=True) * normal
            s = np.fmax((vdir * rdir).sum(-1), 0.0).astype(F32)
            # s**32 via 5 squarings (same op order as the JAX backends).
            s2 = s * s
            s4 = s2 * s2
            s8 = s4 * s4
            s16 = s8 * s8
            spec = s16 * s16

            if kd is None:
                contrib = (diff + spec * F32(0.5))[..., None]
            else:
                contrib = diff[..., None] * kd + (spec * F32(0.5))[..., None]
            final += contrib * lc[None, None, :] * inten

    final = np.clip(final, 0.0, 1.0)
    srgb = final ** F32(1.0 / 2.2)

    rgba = np.zeros((H, W, 4), dtype=np.uint8)
    # Background: blue, alpha 1 (fragment.wgsl:58-62).
    rgba[..., 2] = 255
    rgba[..., 3] = 255
    shaded = np.round(srgb * 255.0).astype(np.uint8)
    rgba[flag, 0] = shaded[flag, 0]
    rgba[flag, 1] = shaded[flag, 1]
    rgba[flag, 2] = shaded[flag, 2]
    if return_float:
        # Pre-quantization channel values (covered pixels only meaningful):
        # lets parity tests prove a 1-LSB backend disagreement is a
        # rounding-boundary tie (value within eps of k + 0.5) rather than
        # a real shading delta.
        return rgba, (srgb * F32(255.0)).astype(F32)
    return rgba
