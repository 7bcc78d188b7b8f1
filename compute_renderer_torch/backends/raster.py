"""Raster + shade over framebuffer tiles: the coefficient table, the
occupied-tile work list, the kernel wrapper and its twin, the RGBA unpack.

Counterpart of the JAX package's ``backends/pallas_raster.py`` in base
mode (32-column table). Per occupied tile, the tile's triangle list is
walked in ascending triangle order; each pixel evaluates the anchored
affine barycentrics and depth, keeps a strict-< running minimum of the u32
depth key (the lowest triangle wins ties), and carries the winner's six
attributes [nx, ny, nz, wx, wy, wz]. The epilogue is ambient 0.1 plus, per
light, a Lambert term and a pow32 x 0.5 Phong term, then clip, gamma
1/2.2, round-half-even and a packed RGBA write; uncovered pixels are the
blue background 0xFFFF0000 (fragment.wgsl:50-93).

A CUDA tensor runs the hand-written kernel ``csrc/raster.cu``; a CPU
tensor runs ``raster_shade_tiles_plain``, the same arithmetic vectorized in
eager torch. The material (35-column), visibility and fused-texture modes
are not ported yet (ROADMAP) and raise ``NotImplementedError``.
"""

from __future__ import annotations

import torch

from compute_renderer_torch.backends import common
from compute_renderer_torch.core.effects import EFFECT_MIRAGE

F32 = torch.float32
I32 = torch.int32

# Table row layout (32 floats) — anchored affine (A, B, C) triples, each
# quantity evaluated per pixel as (A + B*dx) + C*dy with (dx, dy) = sample
# position minus the triangle's vertex-1 anchor:
#   0:3 bc1   3:6 bc2   6:9 bc3   9:12 depth z
#   12:30 six attribute channels [nx, ny, nz, wx, wy, wz]
#   30:32 anchor (v1x, v1y)
TRI_TABLE_WIDTH = 32

# Elements of one (pairs, pixels) block the twin evaluates at a time:
# bounds its memory at a few hundred MB.
_PLAIN_BLOCK = 1 << 21


def _not_ported(what: str):
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP queue 1, item 8: material and "
        "texture extensions)")


def tri_table_columns(screen_soa, nrm_soa, wld_soa, face_kd=None,
                      uv_soa=None, tex_rows=None):
    """The 32 per-triangle coefficient columns as a list of (T,) tensors,
    from corner-SoA inputs: ``screen_soa[k][c]`` is component c (x, y, z,
    w) of corner k; ``nrm_soa`` / ``wld_soa`` likewise with 3 components."""
    if face_kd is not None or uv_soa is not None or tex_rows is not None:
        raise _not_ported("the material / texture table columns")
    v1, v2, v3 = screen_soa
    co = common.barycentric_coefficients(v1[0], v1[1], v2[0], v2[1],
                                         v3[0], v3[1])
    cols = [co["a1"], co["b1"], co["c1"],
            co["a2"], co["b2"], co["c2"],
            co["a3"], co["b3"], co["c3"]]
    cols += list(common.affine_combine(co, v1[2], v2[2], v3[2]))
    for src in (nrm_soa, wld_soa):
        for ch in range(3):
            cols += list(common.affine_combine(co, src[0][ch], src[1][ch],
                                               src[2][ch]))
    cols += [co["ax"], co["ay"]]
    return cols


def build_tri_table(screen, tri, normals, world, face_kd=None):
    """(T, 32) f32 coefficient table from per-vertex screen (N, 4), normals
    (N, 3) and world (N, 3) and (T, 3) triangle indices."""
    if face_kd is not None:
        raise _not_ported("the material table")
    tri = tri.long()
    soa = lambda a, n: tuple(tuple(a[tri[:, k], c] for c in range(n))
                             for k in range(3))
    return torch.stack(
        tri_table_columns(soa(screen, 4), soa(normals.to(F32), 3),
                          soa(world, 3)),
        dim=1,
    )


def occupied_worklist(seg_count):
    """(ascending occupied-tile ids padded with 0, occupied count) — a
    cumsum and a scatter, with no host synchronisation."""
    num_tiles = seg_count.shape[0]
    device = seg_count.device
    occ = seg_count > 0
    incl = torch.cumsum(occ, 0, dtype=I32)
    k = incl[-1] if num_tiles > 0 else torch.zeros((), dtype=I32,
                                                   device=device)
    pos = torch.where(occ, incl - 1, num_tiles).long()
    wl = torch.zeros((num_tiles + 1,), dtype=I32, device=device)
    wl.scatter_(0, pos, torch.arange(num_tiles, dtype=I32, device=device))
    return wl[:num_tiles], k


def shading_inputs(effect, view_position, light_world_pos, light_color,
                   light_intensity):
    """The kernel's (11,) params and (L, 8) light rows, built on the
    device: params = [threshold, melt_threshold, mirage flag, amplitude,
    frequency, phase, time, row offset, eye x, y, z]; a light row =
    [position (3), color (3), intensity, 0]. The row offset places a
    framebuffer stripe of a sharded render; it is 0 until the multi-device
    decompositions are ported."""
    device = effect.device
    threshold, melt_threshold = common.coverage_thresholds(effect)
    zero = torch.zeros((), dtype=F32, device=device)
    mirage = torch.where(effect[0] == EFFECT_MIRAGE, zero + 1.0, zero)
    L = light_world_pos.shape[0]
    params = torch.stack([
        threshold, melt_threshold, mirage, effect[1], effect[2], effect[3],
        effect[5], zero, view_position[0], view_position[1],
        view_position[2],
    ]).to(F32)
    lights = torch.cat([
        light_world_pos.to(F32), light_color.to(F32),
        light_intensity.to(F32)[:, None],
        torch.zeros((L, 1), dtype=F32, device=device),
    ], dim=1).contiguous()
    return params, lights


def _shade(nx, ny, nz, wx, wy, wz, params, lights):
    """The epilogue on (..., pixels) attribute tensors -> packed RGBA as
    int64 holding the u32 pattern (the kernel's op order)."""
    eye_x, eye_y, eye_z = params[8], params[9], params[10]
    r = torch.full_like(nx, 0.1)
    g = torch.full_like(nx, 0.1)
    b = torch.full_like(nx, 0.1)
    vdx = eye_x - wx
    vdy = eye_y - wy
    vdz = eye_z - wz
    vnorm = torch.sqrt(vdx * vdx + vdy * vdy + vdz * vdz)
    vdx = vdx / vnorm
    vdy = vdy / vnorm
    vdz = vdz / vnorm
    zero = torch.zeros((), dtype=F32, device=nx.device)
    for li in range(lights.shape[0]):
        lp = lights[li]
        ldx = lp[0] - wx
        ldy = lp[1] - wy
        ldz = lp[2] - wz
        lnorm = torch.sqrt(ldx * ldx + ldy * ldy + ldz * ldz)
        ldx = ldx / lnorm
        ldy = ldy / lnorm
        ldz = ldz / lnorm
        d = nx * ldx + ny * ldy + nz * ldz
        diff = torch.where(d > 0.0, d, zero)
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
        contrib = diff + (s16 * s16) * 0.5
        r = r + contrib * lp[3] * lp[6]
        g = g + contrib * lp[4] * lp[6]
        b = b + contrib * lp[5] * lp[6]
    gamma = torch.tensor(1.0 / 2.2, dtype=F32)  # f32 constant, as the kernel

    def byte(c):
        c = torch.pow(torch.clamp(c, 0.0, 1.0), gamma.to(c.device))
        return torch.round(c * 255.0).to(I32).to(torch.int64)

    return byte(r) | (byte(g) << 8) | (byte(b) << 16) | 0xFF000000


def raster_shade_tiles_plain(tri_table, pair_data, seg_start, seg_count,
                             params, lights, *, height_padded: int,
                             width_padded: int, tile_h: int, tile_w: int,
                             layout: str):
    """The twin of the kernel, vectorized over (tile, list entry) pairs:
    the occupied tiles' lists are flattened into one pair list in tile
    order (each tile's entries in list order), each block of pairs is
    evaluated over (pairs, pixels), and per tile and pixel the minimum key
    and the first pair that reaches it are merged into the running minimum
    with a strict < — the sequential walk's winner. Returns (rgba, key) as
    (Hp, Wp) int32 holding u32 patterns."""
    device = tri_table.device
    ntx = width_padded // tile_w
    nty = height_padded // tile_h
    num_tiles = ntx * nty
    P = tile_h * tile_w
    i64 = torch.int64
    rgba = torch.full((num_tiles, P), common.BACKGROUND_RGBA, dtype=i64,
                      device=device)
    key = torch.full((num_tiles, P), common.DEPTH_CLEAR, dtype=i64,
                     device=device)

    tiles = torch.nonzero(seg_count > 0).flatten()
    G = tiles.shape[0]
    counts = seg_count[tiles].long()
    # The pair list: pair_tile[p] indexes `tiles`, pair_tri[p] the table.
    pair_tile = torch.repeat_interleave(torch.arange(G, device=device),
                                        counts)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(pair_tile.shape[0], device=device) - first[pair_tile]
    if layout == "dense":
        pair_tri = pair_data[tiles[pair_tile], slot].long()
    else:
        pair_tri = pair_data[seg_start[tiles].long()[pair_tile] + slot].long()

    pix = torch.arange(P, device=device)
    ti = torch.div(tiles, ntx, rounding_mode="floor")
    tj = tiles - ti * ntx
    xs = (pix % tile_w).to(F32)[None, :] + (tj * tile_w).to(F32)[:, None]
    ys = (torch.div(pix, tile_w, rounding_mode="floor").to(F32)[None, :]
          + ((ti * tile_h).to(F32) + params[7])[:, None])
    amplitude, frequency, phase, time = (params[3], params[4], params[5],
                                         params[6])
    px = torch.where(params[2] > 0.5,
                     xs + amplitude * torch.sin(frequency * xs + time + phase),
                     xs)
    py = torch.where(params[2] > 0.5,
                     ys + amplitude * torch.cos(frequency * ys + time + phase),
                     ys)
    cov_min = torch.maximum(params[0], params[1])

    best = torch.full((G, P), common.DEPTH_CLEAR, dtype=i64, device=device)
    best_pair = torch.zeros((G, P), dtype=i64, device=device)
    step = max(1, _PLAIN_BLOCK // P)
    for p0 in range(0, pair_tile.shape[0], step):
        pt = pair_tile[p0:p0 + step]
        rows = tri_table[pair_tri[p0:p0 + step]]  # (n, 32)
        rc = lambda c: rows[:, c:c + 1]
        dx = px[pt] - rc(30)
        dy = py[pt] - rc(31)
        bc1 = rc(0) + rc(1) * dx + rc(2) * dy
        bc2 = rc(3) + rc(4) * dx + rc(5) * dy
        bc3 = rc(6) + rc(7) * dx + rc(8) * dy
        z = rc(9) + rc(10) * dx + rc(11) * dy
        covered = ((bc1 >= cov_min) & (bc2 >= cov_min) & (bc3 >= cov_min)
                   & torch.isfinite(z))
        k = torch.where(covered, common.depth_key(z), common.DEPTH_CLEAR)
        idx = pt[:, None].expand_as(k)
        kmin = torch.full_like(best, common.DEPTH_CLEAR).scatter_reduce(
            0, idx, k, "amin")
        pair_id = torch.arange(p0, p0 + k.shape[0], device=device)[:, None]
        at_min = torch.where(k == kmin[pt], pair_id, torch.iinfo(i64).max)
        first_pair = torch.full_like(best, torch.iinfo(i64).max
                                     ).scatter_reduce(0, idx, at_min, "amin")
        win = kmin < best
        best = torch.where(win, kmin, best)
        best_pair = torch.where(win, first_pair, best_pair)

    if G:
        # The winner's attributes, evaluated as in the walk.
        wrow = tri_table[pair_tri[best_pair]]  # (G, P, 32)
        dx = px - wrow[..., 30]
        dy = py - wrow[..., 31]
        attrs = [wrow[..., 12 + 3 * c] + wrow[..., 13 + 3 * c] * dx
                 + wrow[..., 14 + 3 * c] * dy for c in range(6)]
        shaded = _shade(*attrs, params, lights)
        rgba[tiles] = torch.where(best != common.DEPTH_CLEAR, shaded,
                                  common.BACKGROUND_RGBA)
        key[tiles] = best

    def frame(a):
        return (a.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3)
                .reshape(height_padded, width_padded).to(I32))

    return frame(rgba), frame(key)


def _raster_cuda(tri_table, pair_data, seg_start, seg_count, params, lights,
                 *, height_padded, width_padded, tile_h, tile_w, layout):
    from compute_renderer_torch import _build

    device = tri_table.device
    ntx = width_padded // tile_w
    num_tiles = ntx * (height_padded // tile_h)
    table = tri_table.to(F32).contiguous()
    pairs = pair_data.to(I32).contiguous()
    starts = seg_start.to(I32).contiguous()
    counts = seg_count.to(I32).contiguous()
    wl, k = occupied_worklist(counts)
    k = k.reshape(1).contiguous()
    rgba = torch.full((height_padded, width_padded), common.BACKGROUND_RGBA
                      - (1 << 32), dtype=I32, device=device)
    key = torch.full((height_padded, width_padded), -1, dtype=I32,
                     device=device)
    fn = _build.entry("raster", "raster_shade_tiles_base", pointers=10,
                      ints=8)
    raster_shade_tiles.launches += 1
    _build.check(
        fn(table.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
           counts.data_ptr(), wl.data_ptr(), k.data_ptr(), params.data_ptr(),
           lights.data_ptr(), rgba.data_ptr(), key.data_ptr(), num_tiles,
           lights.shape[0], ntx, tile_h, tile_w, width_padded,
           int(layout == "dense"), pairs.shape[-1] if layout == "dense" else 0,
           torch.cuda.current_stream(device).cuda_stream),
        "raster_shade_tiles",
    )
    return rgba, key


def raster_shade_tiles(tri_table, pair_data, seg_start, seg_count, effect,
                       view_position, light_world_pos, light_color,
                       light_intensity, *, height_padded: int,
                       width_padded: int, tile_h: int, tile_w: int,
                       layout: str = "flat", vis: bool = False,
                       texf: bool = False):
    """Raster + shade the padded framebuffer. ``pair_data`` is the dense
    (num_tiles, C) ``bin_rows`` or the flat tile-sorted ``pair_tri``.
    Returns (rgba_packed (Hp, Wp) u32, best_key (Hp, Wp) u32).

    CPU tensors take the twin, CUDA tensors the kernel
    (``raster_shade_tiles.launches`` counts its launches), launched over
    the occupied-tile work list."""
    if vis or texf or tri_table.shape[1] != TRI_TABLE_WIDTH:
        raise _not_ported("the visibility / texture / material raster mode")
    if layout not in ("dense", "flat"):
        raise ValueError(f"unknown layout {layout!r}")
    params, lights = shading_inputs(effect, view_position, light_world_pos,
                                    light_color, light_intensity)
    kw = dict(height_padded=height_padded, width_padded=width_padded,
              tile_h=tile_h, tile_w=tile_w, layout=layout)
    device = tri_table.device
    if device.type == "cpu":
        rgba, key = raster_shade_tiles_plain(
            tri_table, pair_data, seg_start, seg_count, params, lights, **kw)
    elif device.type == "cuda":
        rgba, key = _raster_cuda(tri_table, pair_data, seg_start, seg_count,
                                 params, lights, **kw)
    else:
        raise ValueError(f"raster_shade_tiles: no kernel for device {device}")
    return rgba.view(torch.uint32), key.view(torch.uint32)


raster_shade_tiles.launches = 0


def unpack_rgba(packed):
    """(H, W) u32 byte-packed -> (H, W, 4) u8 RGBA (little-endian)."""
    return packed.contiguous().view(torch.uint8).reshape(
        *packed.shape, 4)
