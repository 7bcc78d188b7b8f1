"""Raster + shade over framebuffer tiles: the coefficient table, the
occupied-tile work list, the kernel wrapper and its twin, the RGBA unpack.

Counterpart of the JAX package's ``backends/pallas_raster.py``. Per
occupied tile, the tile's triangle list is walked in ascending triangle
order; each pixel evaluates the anchored affine barycentrics and depth and
keeps a strict-< running minimum of the u32 depth key (the lowest triangle
wins ties). The winner's attributes — [nx, ny, nz, wx, wy, wz], evaluated
from its row at the pixel — feed one of three epilogues, by mode:

- ``base`` (32-column table): ambient 0.1 plus, per light, a Lambert term
  and a pow32 x 0.5 Phong term, then clip, gamma 1/2.2, round-half-even
  and a packed RGBA write; uncovered pixels are the blue background
  0xFFFF0000 (fragment.wgsl:50-93);
- ``mat`` (35 columns, kd at 32:35): the same with ambient and diffuse
  modulated by the winner's kd, specular not;
- ``texf`` (44 columns): no shading — the (C, Hp, Wp) f32 G-buffer of
  ``common.TEXF_BASE_CHANNELS`` (interpolated uv, the winner's kd and
  TextureInfo row, per-light diff/spec), which
  ``common.fused_texture_tail`` samples and shades;
- ``texf_mip`` (46 columns, the mip filters): the same G-buffer with the
  winner's ``common.mip_tri_rows`` (tid, lod, mu, mv, spread) in place of
  the TextureInfo row (``common.TEXF_MIP_BASE_CHANNELS``), for
  ``common.fused_texture_tail_mip``;
- ``vis`` (the 32-column base table, deferred texturing): the winner's
  triangle id (the table row), ``common.NO_TRI`` where no triangle
  covers, as (Hp, Wp) int32; ``common.resolve_attributes`` and
  ``common.textured_shade`` shade it.

The mode is an argument: the base and vis tables share their width, so it
cannot be read from the table. A CUDA tensor runs the hand-written kernel
``csrc/raster.cu``; a CPU tensor runs ``raster_shade_tiles_plain``, the
same arithmetic vectorized in eager torch. Both rasters' shading
parameters (``shading_inputs``) are one launch of ``csrc/bins.cu`` on the
card, ``shading_inputs_plain`` on the CPU.
"""

from __future__ import annotations

import torch

from compute_renderer_torch import tracing

from compute_renderer_torch.backends import binning, common
from compute_renderer_torch.backends.binning import occupied_worklist
from compute_renderer_torch.core.effects import EFFECT_MIRAGE

F32 = torch.float32
I32 = torch.int32

# Table row layout (32 floats) — anchored affine (A, B, C) triples, each
# quantity evaluated per pixel as (A + B*dx) + C*dy with (dx, dy) = sample
# position minus the triangle's vertex-1 anchor:
#   0:3 bc1   3:6 bc2   6:9 bc3   9:12 depth z
#   12:30 six attribute channels [nx, ny, nz, wx, wy, wz]
#   30:32 anchor (v1x, v1y)
# Material mode appends 32:35 kd (r, g, b), copied on a win. Fused-texture
# mode appends 32:38 the uv affine triples (u then v), 38:41 kd (ones when
# the mesh has none) and 41:44 the TextureInfo row {off, tw, th} as exact
# f32 ints; the kd and TextureInfo columns are copied, not interpolated.
# The mip-filtered mode puts the (T, 5) common.mip_tri_rows block at 41:46
# in place of the TextureInfo row (46 columns, a row stride of 48).
TRI_TABLE_WIDTH = 32
MAT_TRI_TABLE_WIDTH = 35
TEX_TRI_TABLE_WIDTH = 44
TEX_MIP_TRI_TABLE_WIDTH = 46
# The kernels' MODE argument (csrc/shade.cuh) and each mode's table width.
MODES = {"base": 0, "mat": 1, "texf": 2, "vis": 3, "texf_mip": 4}
MODE_WIDTHS = {"base": TRI_TABLE_WIDTH, "mat": MAT_TRI_TABLE_WIDTH,
               "texf": TEX_TRI_TABLE_WIDTH, "vis": TRI_TABLE_WIDTH,
               "texf_mip": TEX_MIP_TRI_TABLE_WIDTH}
# The vis mode's output where no pair covers a pixel: the tile raster's
# NO_TRI, or the micro raster's PAIR_IDX_CLEAR (pallas_micro.py:63).
PAIR_IDX_CLEAR = 2**31 - 1

# Elements of one (pairs, pixels) block the twin evaluates at a time:
# bounds its memory at a few hundred MB.
_PLAIN_BLOCK = 1 << 21


def tri_table_columns(screen_soa, nrm_soa, wld_soa, face_kd=None,
                      uv_soa=None, tex_rows=None):
    """The per-triangle coefficient columns as a list of (T,) tensors, from
    corner-SoA inputs: ``screen_soa[k][c]`` is component c (x, y, z, w) of
    corner k; ``nrm_soa`` / ``wld_soa`` likewise with 3 components. With
    ``face_kd`` (T, 3) the three kd columns append (35); with ``uv_soa``
    (3 corners, 2, T) and ``tex_rows`` together, the fused-texture columns
    append: 44 with the (T, 3) TextureInfo rows, 46 with the (T, 5)
    ``common.mip_tri_rows``."""
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
    if tex_rows is not None:
        if uv_soa is None:
            raise ValueError("the texf table needs uv corner data (uv_soa)")
        for ch in range(2):
            cols += list(common.affine_combine(
                co, uv_soa[0][ch].to(F32), uv_soa[1][ch].to(F32),
                uv_soa[2][ch].to(F32)))
        if face_kd is not None:
            kd = face_kd.to(F32)
            cols += [kd[:, 0], kd[:, 1], kd[:, 2]]
        else:
            cols += [torch.ones_like(cols[0]) for _ in range(3)]
        tr = tex_rows.to(F32)
        cols += [tr[:, c] for c in range(tr.shape[1])]
    elif face_kd is not None:
        kd = face_kd.to(F32)
        cols += [kd[:, 0], kd[:, 1], kd[:, 2]]
    return cols


def build_tri_table(screen, tri, normals, world, face_kd=None, uvs=None,
                    tex_rows=None):
    """(T, 32 | 35 | 44 | 46) f32 coefficient table from per-vertex screen
    (N, 4), normals (N, 3) and world (N, 3), (T, 3) triangle indices and
    the mode inputs of ``tri_table_columns`` (``uvs`` (N, 2) per vertex)."""
    tri = tri.long()
    soa = lambda a, n: tuple(tuple(a[tri[:, k], c] for c in range(n))
                             for k in range(3))
    return torch.stack(
        tri_table_columns(soa(screen, 4), soa(normals.to(F32), 3),
                          soa(world, 3), face_kd=face_kd,
                          uv_soa=None if uvs is None else soa(uvs.to(F32), 2),
                          tex_rows=tex_rows),
        dim=1,
    )


def check_mode(tri_table, mode: str) -> None:
    """Refuse a mode that names no kernel mode, or a table whose width is
    not the mode's (``MODE_WIDTHS``)."""
    if mode not in MODES:
        raise ValueError(f"unknown raster mode {mode!r} (modes "
                         f"{list(MODES)})")
    width = tri_table.shape[1]
    if width != MODE_WIDTHS[mode]:
        raise ValueError(
            f"a {width}-wide table does not fit mode {mode!r}, which reads "
            f"{MODE_WIDTHS[mode]} columns (widths {MODE_WIDTHS})")


def output_channels(mode: str, num_lights: int) -> int:
    """Planes of a G-buffer mode's (C, Hp, Wp) f32 output (0: the packed
    RGBA or vis ids, one (Hp, Wp) int32 plane)."""
    if mode == "texf":
        return common.texf_channels(num_lights)
    if mode == "texf_mip":
        return common.texf_mip_channels(num_lights)
    return 0


def table_stride(width: int) -> int:
    """Row stride of the kernels' tables: ``width`` rounded up to a
    multiple of 4 floats (32, 36, 44, 48), so that rows load as float4."""
    return (width + 3) // 4 * 4


def empty_table(T: int, width: int, device):
    """An uninitialized (T, width) f32 table in the kernels' layout: a view
    of (T, ``table_stride(width)``) storage, unit column stride, 16-byte
    aligned. The front end writes its rows into one."""
    out = torch.empty((T, table_stride(width)), dtype=F32, device=device)
    return out[:, :width]


def kernel_table(tri_table):
    """The (T, R) f32 table as the CUDA kernels read it: unit column
    stride, a row stride of ``table_stride(R)`` and a 16-byte aligned
    base. Returns the table itself when it already has that layout (as the
    front end writes it, ``empty_table``), else a padded copy, counted in
    ``kernel_table.copies``. No kernel reads the pad column."""
    T, R = tri_table.shape
    stride = table_stride(R)
    if (tri_table.dtype == F32 and tri_table.stride(1) == 1
            and (T <= 1 or tri_table.stride(0) == stride)
            and tri_table.data_ptr() % 16 == 0):
        return tri_table, stride
    kernel_table.copies += 1
    out = empty_table(T, R, tri_table.device)
    out.copy_(tri_table)
    return out, stride


kernel_table.copies = 0


def shading_inputs_plain(effect, view_position, light_world_pos,
                         light_color, light_intensity, y_offset: int = 0):
    """The twin of ``shading_inputs``, in torch ops."""
    device = effect.device
    threshold, melt_threshold = common.coverage_thresholds(effect)
    zero = torch.zeros((), dtype=F32, device=device)
    mirage = torch.where(effect[0] == EFFECT_MIRAGE, zero + 1.0, zero)
    L = light_world_pos.shape[0]
    params = torch.stack([
        threshold, melt_threshold, mirage, effect[1], effect[2], effect[3],
        effect[5], zero + float(y_offset), view_position[0],
        view_position[1], view_position[2],
    ]).to(F32)
    lights = torch.cat([
        light_world_pos.to(F32), light_color.to(F32),
        light_intensity.to(F32)[:, None],
        torch.zeros((L, 1), dtype=F32, device=device),
    ], dim=1).contiguous()
    return params, lights


def _shading_cuda(effect, view_position, light_world_pos, light_color,
                  light_intensity, y_offset):
    from compute_renderer_torch import _build

    device = effect.device
    L = light_world_pos.shape[0]
    inputs = [a.to(device=device, dtype=F32).contiguous() for a in (
        effect, view_position, light_world_pos, light_color,
        light_intensity)]
    if inputs[0].numel() < 6 or inputs[1].numel() < 3:
        raise ValueError(f"effect has {inputs[0].numel()} values (6) and "
                         f"view_position {inputs[1].numel()} (3 or more)")
    for a, width in zip(inputs[2:], (3, 3, 1)):
        if a.numel() != L * width:
            raise ValueError(f"a light tensor of {tuple(a.shape)} for {L} "
                             "lights")
    params = torch.empty((11,), dtype=F32, device=device)
    lights = torch.empty((L, 8), dtype=F32, device=device)
    fn = _build.entry("bins", "shading_params", pointers=7, ints=2)
    tracing.launch("shading_inputs")
    _build.check(
        fn(*(a.data_ptr() for a in inputs), params.data_ptr(),
           lights.data_ptr(), L, y_offset,
           torch.cuda.current_stream(device).cuda_stream),
        "shading_params",
    )
    return params, lights


def shading_inputs(effect, view_position, light_world_pos, light_color,
                   light_intensity, y_offset: int = 0):
    """The rasters' (11,) params and (L, 8) light rows, built on the
    device: params = [threshold, melt_threshold, mirage flag, amplitude,
    frequency, phase, time, row offset, eye x, y, z]; a light row =
    [position (3), color (3), intensity, 0]. The row offset ``y_offset``
    places a framebuffer stripe of a sharded render (``parallel/``): the
    kernels and twins sample global row ``y + y_offset``, an exact f32
    integer.

    CPU tensors take the twin, CUDA tensors the kernel ``csrc/bins.cu``
    (``shading_params``; ``launches.shading_inputs`` of
    ``tracing.counters()`` counts its launches)."""
    args = (effect, view_position, light_world_pos, light_color,
            light_intensity, int(y_offset))
    if effect.device.type == "cpu":
        return shading_inputs_plain(*args)
    if effect.device.type != "cuda":
        raise ValueError(f"shading_inputs: no kernel for device "
                         f"{effect.device}")
    return _shading_cuda(*args)



def shade_pixels(attrs, params, lights, kd=None):
    """The shading epilogue on (..., pixels) tensors -> packed RGBA as int64
    holding the u32 pattern. ``attrs`` = [nx, ny, nz, wx, wy, wz]; ``kd``
    (r, g, b) selects the material form (ambient and diffuse modulated)."""
    nx = attrs[0]
    if kd is None:
        r = torch.full_like(nx, 0.1)
        g = torch.full_like(nx, 0.1)
        b = torch.full_like(nx, 0.1)
    else:
        r, g, b = 0.1 * kd[0], 0.1 * kd[1], 0.1 * kd[2]
    for li, diff, spec in common.light_terms(attrs[0:3], attrs[3:6],
                                             params[8:11], lights):
        lp = lights[li]
        if kd is None:
            contrib = diff + spec * 0.5
            r = r + contrib * lp[3] * lp[6]
            g = g + contrib * lp[4] * lp[6]
            b = b + contrib * lp[5] * lp[6]
        else:
            half = spec * 0.5
            r = r + (diff * kd[0] + half) * lp[3] * lp[6]
            g = g + (diff * kd[1] + half) * lp[4] * lp[6]
            b = b + (diff * kd[2] + half) * lp[5] * lp[6]
    gamma = torch.tensor(1.0 / 2.2, dtype=F32)  # f32 constant, as the kernel

    def byte(c):
        c = torch.pow(torch.clamp(c, 0.0, 1.0), gamma.to(c.device))
        return torch.round(c * 255.0).to(I32).to(torch.int64)

    return byte(r) | (byte(g) << 8) | (byte(b) << 16) | 0xFF000000


def texf_planes(attrs, params, lights):
    """The texf / texf_mip G-buffer channels from the winner's attributes
    [nx, ny, nz, wx, wy, wz, u, v, then the copied columns: kd (3) and the
    TextureInfo row (3) or the mip rows (5)]: uv and the copied columns,
    then per light the shading epilogue's diff and spec."""
    planes = list(attrs[6:])
    for _, diff, spec in common.light_terms(attrs[0:3], attrs[3:6],
                                            params[8:11], lights):
        planes += [diff, spec]
    return planes


def _tile_pairs(pair_data, seg_start, seg_count, layout):
    """The occupied tiles' lists flattened in tile order, each tile's
    entries in list order: (tiles, pair_tile, pair_tri, pair_pos), with
    ``pair_tile`` indexing ``tiles``, ``pair_tri`` the table and
    ``pair_pos`` the flat ``pair_data`` (None for the dense layout)."""
    device = seg_count.device
    tiles = torch.nonzero(seg_count > 0).flatten()
    counts = seg_count[tiles].long()
    pair_tile = torch.repeat_interleave(
        torch.arange(tiles.shape[0], device=device), counts)
    first = torch.cumsum(counts, 0) - counts
    slot = torch.arange(pair_tile.shape[0], device=device) - first[pair_tile]
    if layout == "dense":
        return tiles, pair_tile, pair_data[tiles[pair_tile], slot].long(), None
    pair_pos = seg_start[tiles].long()[pair_tile] + slot
    return tiles, pair_tile, pair_data[pair_pos].long(), pair_pos


def _tile_samples(params, tiles, ntx, tile_h, tile_w):
    """(px, py), each (G, tile_h * tile_w): the tiles' sample positions
    in row-major pixel order, with the mirage warp applied as the kernels
    apply it."""
    P = tile_h * tile_w
    pix = torch.arange(P, device=tiles.device)
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
    return px, py


def _walk_plain(tri_table, unit, tri, order, px, py, cov_min):
    """The walk, vectorized over (entry, pixel): entry e tests row
    ``tri[e]`` at the samples ``px[unit[e]]``, ``py[unit[e]]`` (U, P).
    Returns per unit and pixel the minimum key and the ``order`` of the
    first entry that reaches it (the strict-< walk's winner when ``order``
    ascends within each unit; 0 where no entry covers). Blocks of entries
    bound the memory."""
    device = tri_table.device
    i64 = torch.int64
    big = torch.iinfo(i64).max
    best = torch.full(px.shape, common.DEPTH_CLEAR, dtype=i64, device=device)
    best_order = torch.zeros(px.shape, dtype=i64, device=device)
    step = max(1, _PLAIN_BLOCK // max(px.shape[1], 1))
    for p0 in range(0, unit.shape[0], step):
        pt = unit[p0:p0 + step]
        rows = tri_table[tri[p0:p0 + step]]  # (n, R)
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
        at_min = torch.where(k == kmin[pt], order[p0:p0 + step, None], big)
        first = torch.full_like(best, big).scatter_reduce(0, idx, at_min,
                                                          "amin")
        win = kmin < best
        best = torch.where(win, kmin, best)
        best_order = torch.where(win, first, best_order)
    return best, best_order


def _emit_plain(tri_table, best, win_tri, win_id, px, py, params, lights,
                mode, no_id):
    """The epilogue on (U, P) units: ``out`` by mode (as the kernels' —
    vis ids ``win_id``, the packed RGBA or the (C, U, P) G-buffer) from the
    winners' table rows ``win_tri``, where ``best`` is covered."""
    hit = best != common.DEPTH_CLEAR
    if mode == "vis":
        return torch.where(hit, win_id, no_id)
    # The winner's attributes, evaluated from its row at the pixel.
    wrow = tri_table[win_tri]  # (U, P, R)
    dx = px - wrow[..., 30]
    dy = py - wrow[..., 31]
    affine = lambda c: wrow[..., c] + wrow[..., c + 1] * dx \
        + wrow[..., c + 2] * dy
    attrs = [affine(12 + 3 * c) for c in range(6)]
    if output_channels(mode, lights.shape[0]):  # texf, texf_mip
        attrs += [affine(32), affine(35)]
        attrs += [wrow[..., c] for c in range(38, tri_table.shape[1])]
        return torch.where(hit, torch.stack(texf_planes(attrs, params, lights)),
                           0.0)
    kd = [wrow[..., 32 + c] for c in range(3)] if mode == "mat" else None
    shaded = shade_pixels(attrs, params, lights, kd)
    return torch.where(hit, shaded, common.BACKGROUND_RGBA)


def _frame_outputs(tri_table, tiles, best, win_tri, win_id, px, py, params,
                   lights, *, height_padded, width_padded, tile_h, tile_w,
                   mode, no_id):
    """(out, key) of the padded frame from the occupied tiles' winners
    (G, tile_h * tile_w): the epilogue, the cleared outputs elsewhere,
    tiles put back in place."""
    device = tri_table.device
    ntx = width_padded // tile_w
    nty = height_padded // tile_h
    num_tiles = ntx * nty
    P = tile_h * tile_w
    i64 = torch.int64
    key = torch.full((num_tiles, P), common.DEPTH_CLEAR, dtype=i64,
                     device=device)
    channels = output_channels(mode, lights.shape[0])
    if channels:
        out = torch.zeros((channels, num_tiles, P), dtype=F32, device=device)
    else:
        out = torch.full((num_tiles, P), no_id if mode == "vis"
                         else common.BACKGROUND_RGBA, dtype=i64,
                         device=device)
    if tiles.shape[0]:
        emitted = _emit_plain(tri_table, best, win_tri, win_id, px, py,
                              params, lights, mode, no_id)
        if channels:
            out[:, tiles] = emitted
        else:
            out[tiles] = emitted
        key[tiles] = best

    def frame(a):
        return (a.reshape(nty, ntx, tile_h, tile_w).permute(0, 2, 1, 3)
                .reshape(height_padded, width_padded))

    if channels:
        out = torch.stack([frame(c) for c in out])
    else:
        out = frame(out).to(I32)
    return out, frame(key).to(I32)


def raster_shade_tiles_plain(tri_table, pair_data, seg_start, seg_count,
                             params, lights, *, height_padded: int,
                             width_padded: int, tile_h: int, tile_w: int,
                             layout: str, mode: str = "base",
                             pair_ids: bool = False):
    """The twin of the kernel, vectorized over (tile, list entry) pairs:
    the occupied tiles' lists are flattened into one pair list in tile
    order (each tile's entries in list order), each block of pairs is
    evaluated over (pairs, pixels), and per tile and pixel the minimum key
    and the first pair that reaches it are merged into the running minimum
    with a strict < — the sequential walk's winner. Returns (out, key) as
    (Hp, Wp) int32, ``key`` holding u32 patterns and ``out`` by mode: the
    packed RGBA (base, mat); the winner's triangle id or ``common.NO_TRI``
    (vis; with ``pair_ids`` its index in the flat ``pair_data`` or
    ``PAIR_IDX_CLEAR``, the micro raster's output); or the (C, Hp, Wp) f32
    G-buffer (texf, texf_mip; zeros where no triangle covers, one of the
    values the kernel's undefined planes may hold)."""
    if pair_ids and layout != "flat":
        raise ValueError("pair_ids index the flat pair list")
    tiles, pair_tile, pair_tri, pair_pos = _tile_pairs(
        pair_data, seg_start, seg_count, layout)
    px, py = _tile_samples(params, tiles, width_padded // tile_w, tile_h,
                           tile_w)
    cov_min = torch.maximum(params[0], params[1])
    order = torch.arange(pair_tri.shape[0], device=tri_table.device)
    best, first = _walk_plain(tri_table, pair_tile, pair_tri, order, px, py,
                              cov_min)
    win_id = (pair_pos if pair_ids else pair_tri)[first]
    return _frame_outputs(
        tri_table, tiles, best, pair_tri[first], win_id, px, py, params,
        lights, height_padded=height_padded, width_padded=width_padded,
        tile_h=tile_h, tile_w=tile_w, mode=mode,
        no_id=PAIR_IDX_CLEAR if pair_ids else common.NO_TRI)


# The kernel's decomposition of a tile (csrc/raster.cu): sub-rectangles of
# four PATCH x PATCH patches, one block each (16x16 in a tile of a multiple
# of 16 rows, else 8x32), a warp a patch; in the flat layout a list of more
# than binning.TILE_SPAN entries cut into spans of that many list
# positions, a block each.
SUB_TALL = (16, 16)
SUB_SHORT = (8, 32)
PATCH = 8


def sub_shape(tile_h: int) -> tuple:
    """The kernel's (SUB_H, SUB_W) sub-rectangle for tiles of ``tile_h``
    rows."""
    return SUB_TALL if tile_h % SUB_TALL[0] == 0 else SUB_SHORT


def cull_rect_plain(rows, x0, x1, y0, y1, cov_min):
    """The kernel's cull (csrc/walk.cuh ``may_cover``) in float32 torch,
    op for op: for (N, R) table rows and sample rectangles [x0, x1] x
    [y0, y1] (float32, broadcast against N), False only where some
    barycentric plane A + B*dx + C*dy, evaluated at the rectangle's highest
    corner with the walk's own float operations, (A + max(B*dxl, B*dxh))
    + max(C*dyl, C*dyh), is below ``cov_min``. dxl and dxh are the float
    differences of the rectangle's edges and the anchor; rounding is
    monotone in each operand, so that corner value bounds every sample's
    own float barycentric exactly, with no margin. Non-finite rectangles,
    anchors or planes, and NaN maxima, cull nothing."""
    ax, ay = rows[:, 30], rows[:, 31]
    dxl, dxh = x0 - ax, x1 - ax
    dyl, dyh = y0 - ay, y1 - ay
    finite = (torch.isfinite(dxl) & torch.isfinite(dxh) & torch.isfinite(dyl)
              & torch.isfinite(dyh))
    bound = torch.as_tensor(cov_min, dtype=F32, device=rows.device)
    culled = torch.zeros(rows.shape[0], dtype=torch.bool, device=rows.device)
    for k in range(3):
        a, b, c = (rows[:, 3 * k + i] for i in range(3))
        ok = finite & torch.isfinite(a) & torch.isfinite(b) & torch.isfinite(c)
        hi = (a + torch.maximum(b * dxl, b * dxh)
              + torch.maximum(c * dyl, c * dyh))
        culled |= ok & (hi < bound)
    return ~culled


def _nan_rect(x, y, valid):
    """Per row of (N, P) samples: (x0, x1, y0, y1), the min and max over
    the valid samples with NaNs left out (fminf / fmaxf), NaN where none
    is left."""
    def lo_hi(v):
        keep = valid & ~torch.isnan(v)
        inf = torch.tensor(float("inf"), dtype=F32, device=v.device)
        lo = torch.where(keep, v, inf).amin(1)
        hi = torch.where(keep, v, -inf).amax(1)
        none = ~keep.any(1)
        return (torch.where(none, float("nan"), lo),
                torch.where(none, float("nan"), hi))

    return (*lo_hi(x), *lo_hi(y))


def raster_shade_subtiles_plain(tri_table, pair_data, seg_start, seg_count,
                                params, lights, *, height_padded: int,
                                width_padded: int, tile_h: int, tile_w: int,
                                layout: str, mode: str = "base",
                                stats: dict | None = None):
    """The kernel's decomposition of ``raster_shade_tiles_plain``, in
    torch (tests only): each occupied tile is cut into ``sub_shape(tile_h)``
    sub-rectangles and these into PATCH x PATCH patches (pixels past the
    tile left out); in the flat layout a tile's list of more than
    ``binning.TILE_SPAN`` entries is cut into spans of that many list
    positions (read when called). A list entry
    reaches a patch only if ``cull_rect_plain`` keeps it against the
    sub-rectangle's sample rectangle and then against the patch's; each
    (span, patch) reduces what reaches it to the (key, list position)
    minimum of its pixels (the kernel's warps share a round's entries and
    merge them so), and the spans of a tile merge per pixel by an "amin"
    of the int64 words ((key - 2^31) << 32) + position, the key's top bit
    flipped so that signed order is its unsigned order (the kernel's
    64-bit atomicMin). Equal to ``raster_shade_tiles_plain`` bitwise: a
    culled entry covers no sample of its block. With ``stats`` (a dict),
    the counts of pairs, of (pair, sub-rectangle) and (pair, patch)
    survivors and of span blocks beyond each tile's first, the most
    survivors a block and a patch walk, and the samples walked, are
    written into it."""
    device = tri_table.device
    i64 = torch.int64
    none = torch.iinfo(i64).max
    span = binning.TILE_SPAN
    sub_h, sub_w = sub_shape(tile_h)
    tiles, pair_tile, pair_tri, _ = _tile_pairs(pair_data, seg_start,
                                                seg_count, layout)
    px, py = _tile_samples(params, tiles, width_padded // tile_w, tile_h,
                           tile_w)
    cov_min = torch.maximum(params[0], params[1])
    # Patch k of a tile: its 64 pixels' tile pixel index, -1 past the tile,
    # and its sub-rectangle.
    nsy, nsx = -(-tile_h // sub_h), -(-tile_w // sub_w)
    nsub = nsy * nsx
    per_sub = (sub_h // PATCH) * (sub_w // PATCH)
    k = torch.arange(nsub * per_sub, device=device)
    sub = torch.div(k, per_sub, rounding_mode="floor")
    w = k - sub * per_sub
    q = torch.arange(PATCH * PATCH, device=device)
    r = (torch.div(sub, nsx, rounding_mode="floor")[:, None] * sub_h
         + torch.div(w, sub_w // PATCH, rounding_mode="floor")[:, None]
         * PATCH + torch.div(q, PATCH, rounding_mode="floor")[None, :])
    c = ((sub % nsx)[:, None] * sub_w + (w % (sub_w // PATCH))[:, None]
         * PATCH + (q % PATCH)[None, :])
    valid = (r < tile_h) & (c < tile_w)
    pix = torch.where(valid, r * tile_w + c, 0)  # (K, 64)
    K = k.shape[0]
    G = tiles.shape[0]

    # Rectangles: (G, K) per patch, (G, nsub) per sub-rectangle.
    gx, gy = px[:, pix], py[:, pix]  # (G, K, 64)
    patch_valid = valid[None].expand(G, K, -1)
    prect = [v.reshape(G, K) for v in _nan_rect(
        gx.reshape(G * K, -1), gy.reshape(G * K, -1),
        patch_valid.reshape(G * K, -1))]
    srect = [v.reshape(G, nsub) for v in _nan_rect(
        gx.reshape(G * nsub, -1), gy.reshape(G * nsub, -1),
        patch_valid.reshape(G * nsub, -1))]

    # Each entry's span: its list position // span in a flat list longer
    # than span, else 0 (the whole list).
    n = pair_tri.shape[0]
    counts = seg_count[tiles].long()
    slot = (torch.arange(n, device=device)
            - (torch.cumsum(counts, 0) - counts)[pair_tile])
    cut = counts > span if layout == "flat" else torch.zeros_like(
        counts, dtype=torch.bool)
    piece = torch.where(cut[pair_tile],
                        torch.div(slot, span, rounding_mode="floor"), 0)
    pieces = int(piece.max()) + 1 if n else 1

    # Entries (pair, patch) that pass both culls, in (tile, span, patch,
    # list) order; a patch with no valid pixel walks nothing.
    rows = tri_table[pair_tri]
    keep_sub = torch.stack([cull_rect_plain(
        rows, *(v[pair_tile, s] for v in srect), cov_min)
        for s in range(nsub)], 1)  # (n, nsub)
    keep = torch.stack([cull_rect_plain(
        rows, *(v[pair_tile, kk] for v in prect), cov_min)
        for kk in range(K)], 1) & keep_sub[:, sub] & valid.any(1)[None]
    pair, patch = torch.nonzero(keep, as_tuple=True)
    unit_key = (pair_tile[pair] * pieces + piece[pair]) * K + patch
    order = torch.sort(unit_key * max(n, 1) + pair).indices
    pair, unit_key = pair[order], unit_key[order]
    units, unit = torch.unique(unit_key, return_inverse=True)
    home = (torch.div(units, pieces * K, rounding_mode="floor") * K
            + units % K)  # each unit's (tile, patch)
    best_u, first = _walk_plain(
        tri_table, unit, pair_tri[pair], pair, gx.reshape(G * K, -1)[home],
        gy.reshape(G * K, -1)[home], cov_min)
    word = torch.where(best_u != common.DEPTH_CLEAR,
                       ((best_u - 2**31) << 32) + first, none)
    merged = torch.full((G * K, PATCH * PATCH), none, dtype=i64,
                        device=device).scatter_reduce(
        0, home[:, None].expand_as(word), word, "amin")
    hit = merged != none
    best_p = torch.where(hit, (merged >> 32) + 2**31, common.DEPTH_CLEAR)
    first_p = torch.where(hit, merged & 0xFFFFFFFF, 0)

    # Back to the tiles' pixel order, then the tile twin's epilogue.
    best = torch.full((G, tile_h * tile_w), common.DEPTH_CLEAR,
                      dtype=i64, device=device)
    winner = torch.zeros_like(best)
    dest = (torch.arange(G, device=device)[:, None, None] * (tile_h * tile_w)
            + pix[None]).reshape(-1)
    sel = patch_valid.reshape(-1)
    best.view(-1)[dest[sel]] = best_p.reshape(-1)[sel]
    winner.view(-1)[dest[sel]] = first_p.reshape(-1)[sel]
    if stats is not None:
        blocks = ((pair_tile * pieces + piece)[:, None] * nsub
                  + torch.arange(nsub, device=device))
        per_block = torch.zeros(max(G * pieces * nsub, 1), dtype=i64,
                                device=device).index_add_(
            0, blocks.reshape(-1), keep_sub.reshape(-1).long())
        per_patch = torch.bincount(unit, minlength=1)
        stats.update(pairs=n, sub_survivors=int(keep_sub.sum()),
                     patch_survivors=int(keep.sum()),
                     spans=int(torch.where(cut, torch.div(
                         counts - 1, span, rounding_mode="floor"), 0).sum()),
                     block_max=int(per_block.max()) if n else 0,
                     patch_max=int(per_patch.max()) if n else 0,
                     samples_unculled=n * tile_h * tile_w,
                     samples_walked=int(keep.sum()) * PATCH * PATCH)
    return _frame_outputs(
        tri_table, tiles, best, pair_tri[winner], pair_tri[winner], px, py,
        params, lights, height_padded=height_padded,
        width_padded=width_padded, tile_h=tile_h, tile_w=tile_w, mode=mode,
        no_id=common.NO_TRI)


def cleared_outputs(mode, num_lights, height_padded, width_padded, device,
                    no_id=common.NO_TRI):
    """The kernels' pre-cleared (out, key): what an empty tile keeps — the
    background RGBA or the vis ``no_id``, and the cleared key (-1 as
    int32). A G-buffer's planes are left unwritten: they are defined where
    the key is set and undefined elsewhere, and every reader masks by the
    key (``defined_planes``)."""
    channels = output_channels(mode, num_lights)
    if channels:
        out = torch.empty((channels, height_padded, width_padded), dtype=F32,
                          device=device)
    else:
        fill = (no_id if mode == "vis"
                else common.BACKGROUND_RGBA - (1 << 32))
        out = torch.full((height_padded, width_padded), fill, dtype=I32,
                         device=device)
    key = torch.full((height_padded, width_padded), -1, dtype=I32,
                     device=device)
    return out, key


def defined_planes(out, key):
    """``out`` as the G-buffer contract defines it: a (C, H, W) G-buffer's
    planes with every pixel whose ``key`` (H, W; u32 or int32) is clear
    set to 0, the plain twins' value there; any other output as it is.
    For comparing two G-buffers bit for bit."""
    if out.dim() != 3:
        return out
    return torch.where(key.view(I32) != -1, out, 0.0)


def public_outputs(mode, out, key):
    """The wrappers' output types: packed RGBA as u32, vis ids as int32,
    G-buffers as f32; keys as u32."""
    if mode in ("base", "mat"):
        out = out.view(torch.uint32)
    return out, key.view(torch.uint32)


def _raster_cuda(tri_table, pair_data, seg_start, seg_count, params, lights,
                 *, height_padded, width_padded, tile_h, tile_w, layout,
                 mode, worklist, spans=None):
    from compute_renderer_torch import _build

    device = tri_table.device
    ntx = width_padded // tile_w
    num_tiles = ntx * (height_padded // tile_h)
    table, row_stride = kernel_table(tri_table)
    pairs = pair_data.to(I32).contiguous()
    starts = seg_start.to(I32).contiguous()
    counts = seg_count.to(I32).contiguous()
    wl, k = worklist
    if wl.dtype != I32 or wl.shape != (num_tiles,) or k.dtype != I32:
        raise ValueError(f"worklist {wl.dtype} {tuple(wl.shape)}, k {k.dtype}"
                         f": expected int32, {num_tiles} tiles")
    wl = wl.contiguous()
    k = k.reshape(1).contiguous()
    out, key = cleared_outputs(mode, lights.shape[0], height_padded,
                               width_padded, device)
    # The flat layout's span list and the span merge's words and counters
    # (the padded frame's, made eagerly, left clear by every launch); the
    # dense layout walks every list whole and takes none.
    merge = arrivals = None
    if (layout == "flat") != (spans is not None):
        raise ValueError(f"raster_shade_tiles: the {layout} layout with"
                         f"{'' if spans is not None else 'out'} a span list")
    if spans is not None:
        if (spans.dtype != I32 or spans.dim() != 1 or spans.shape[0] < 3
                or spans.shape[0] % 2 == 0):
            raise ValueError(f"spans {spans.dtype} {tuple(spans.shape)}: "
                             "expected int32 [count, (tile, k) ...]")
        spans = spans.contiguous()
        merge, arrivals = common.merge_scratch(device, height_padded,
                                               width_padded)
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    fn = _build.entry("raster", "raster_shade_tiles", pointers=13, ints=11)
    tracing.launch("raster_shade_tiles", mode)
    _build.check(
        fn(table.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
           counts.data_ptr(), wl.data_ptr(), k.data_ptr(), params.data_ptr(),
           lights.data_ptr(), out.data_ptr(), key.data_ptr(), ptr(spans),
           ptr(merge), ptr(arrivals), MODES[mode], row_stride, num_tiles,
           lights.shape[0], ntx, tile_h, tile_w, width_padded,
           int(layout == "dense"),
           pairs.shape[-1] if layout == "dense" else 0,
           0 if spans is None else spans.shape[0] // 2,
           torch.cuda.current_stream(device).cuda_stream),
        "raster_shade_tiles",
    )
    return out, key


def raster_shade_tiles(tri_table, pair_data, seg_start, seg_count, effect,
                       view_position, light_world_pos, light_color,
                       light_intensity, *, height_padded: int,
                       width_padded: int, tile_h: int, tile_w: int,
                       layout: str = "flat", mode: str = "base",
                       y_offset: int = 0, worklist=None, spans=None):
    """Raster + shade the padded framebuffer in ``mode`` (``MODES``; the
    table must have the mode's width, ``check_mode``). ``pair_data`` is
    the dense (num_tiles, C) ``bin_rows`` or the flat tile-sorted
    ``pair_tri``. ``y_offset`` is the global row of the framebuffer's
    first row (a stripe of a sharded render; ``shading_inputs``). Returns
    (out, best_key (Hp, Wp) u32), ``out`` by mode:
    the packed RGBA (Hp, Wp) u32 (base, mat), the winner's table row
    (Hp, Wp) int32, -1 where none covers (vis), or the (C, Hp, Wp) f32
    G-buffer (texf, texf_mip), whose planes are defined where the key is
    set and undefined elsewhere (the kernel leaves them unwritten; the
    twin holds zeros there).

    CPU tensors take the twin, CUDA tensors the kernel
    (``launches.raster_shade_tiles`` of ``tracing.counters()`` counts its
    launches, ``launches.raster_shade_tiles.<mode>`` per mode; a CUDA
    graph's capture ticks them, its replays do not), launched over the
    occupied-tile work list:
    ``worklist`` = (ids, k) as ``occupied_worklist`` gives them for
    ``seg_count``, and in the flat layout over ``spans``, the span
    list (``binning.span_list_plain``): a tile whose list is longer than
    ``binning.TILE_SPAN`` is walked a span a block and merged exactly.
    The main path passes the ones ``binning.bin_tiles_meta`` returns; a
    caller that bins by hand may pass None for either, and it is built
    here. The twin walks the occupied tiles itself."""
    check_mode(tri_table, mode)
    if layout not in ("dense", "flat"):
        raise ValueError(f"unknown layout {layout!r}")
    params, lights = shading_inputs(effect, view_position, light_world_pos,
                                    light_color, light_intensity, y_offset)
    kw = dict(height_padded=height_padded, width_padded=width_padded,
              tile_h=tile_h, tile_w=tile_w, layout=layout, mode=mode)
    device = tri_table.device
    if device.type == "cpu":
        out, key = raster_shade_tiles_plain(
            tri_table, pair_data, seg_start, seg_count, params, lights, **kw)
    elif device.type == "cuda":
        if worklist is None:
            worklist = occupied_worklist(seg_count)
        if layout == "flat" and spans is None:
            spans = binning.span_list_plain(seg_count, pair_data.shape[0])
        out, key = _raster_cuda(tri_table, pair_data, seg_start, seg_count,
                                params, lights, worklist=worklist,
                                spans=spans, **kw)
    else:
        raise ValueError(f"raster_shade_tiles: no kernel for device {device}")
    return public_outputs(mode, out, key)



def unpack_rgba(packed):
    """(H, W) u32 byte-packed -> (H, W, 4) u8 RGBA (little-endian)."""
    return packed.contiguous().view(torch.uint8).reshape(
        *packed.shape, 4)
