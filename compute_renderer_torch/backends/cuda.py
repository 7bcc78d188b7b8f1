"""The GPU engine: the tile path and the micro (mega-scene) path.

Counterpart of the JAX package's ``backends/tpu.py`` (``render_frame`` at
tpu.py:511-817, ``render_frame_micro`` at :87-417, its ``micro_vis_tail``
at :448-482 in ``finish_frame``, the capacity helpers, ``texf_eligible``
and the retrying ``render``) in every mode of its kernels (``frame_mode``, as
tpu.py:196-206 and :618-627 pick it):

- ``base`` and ``mat`` (``face_kd``: 35-column table, kd-modulated
  shading): the raster kernels shade;
- ``texf`` (a textured mesh, nearest or bilinear filter, fused texturing:
  44-column table): the kernels write a G-buffer and
  ``texture.texture_tail`` samples the atlas and shades;
- ``texf_mip`` (trilinear or anisotropic, fused): the frame's mip rows
  (``texture.mip_rows``) ride a 46-column table and
  ``texture.texture_tail_mip`` samples the mip pool;
- ``vis`` (``tex_mode="deferred"``, which ``mesh_ext_tensors`` also picks
  for atlases of 2^24 texels or more): the kernels write the winner's id
  on the base table, and ``texture.deferred_tail`` resolves, samples and
  shades it (under a mip filter on the frame's ``texture.mip_rows``).

Tile path, per frame:

1. ``front.front_end`` — vertex stage, setup and the coefficient table in
   one kernel, at tile granularity, in the layout the rasters read (no
   copy between them); texf_mip and vis also launch ``texture.mip_rows``
   under a mip filter, and vis launches ``texture.vertex_stage`` for the
   per-vertex screen and world the deferred tail reads;
2. ``binning.bin_tiles_meta`` on the front's meta: the bins, the
   occupied-tile work list and the overflow report (dense at Suzanne
   scale, one kernel; above ``DENSE_BINNING_OP_LIMIT`` the flat layout:
   the pair expansion and the bin sort, ``csrc/sort.cu``, whose scan
   also writes the span list of the tiles whose lists are long);
3. ``raster.raster_shade_tiles`` over the occupied tiles and the span
   list, its shading parameters built by one kernel
   (``raster.shading_inputs``);
4. ``raster.unpack_rgba``, or the mode's texture tail.

Micro path (``render_frame_micro``), for scenes above
``TILE_PATH_MAX_TRIANGLES``:

1. ``front.front_end`` at 8x8-cell granularity;
2. ``binning.bin_cells_sort_meta`` — the pair-expansion kernel, then the
   bin sort kernel: the cell-sorted pairs, segments and work list;
3. ``micro.raster_shade_micro`` over the occupied 8x128 tiles;
4. as on the tile path (vis maps the winner's pair index to its triangle
   through the sorted pair list first).

Nothing in a frame waits for the host: the overflow report stays a device
tensor, and the occupied-tile count is read by the kernels themselves. So
a frame can be captured into a CUDA graph, as the renderer does; ``acc``,
a (7,) int64 device tensor, gathers a batch's needs, pairs, occupied tiles
and longest bin list from the binning of each frame (``binning``'s module
docstring), the coverage samples the micro raster tested and the pixels
the mip texture tail shaded from an image.
The texture work of a frame runs inside the spans named
``TEXTURE_RANGES`` (``tracing.span``), so that a profile of eager frames
can split it out (a graph's replay records no ranges).
"""

from __future__ import annotations

import numpy as np
import torch

from compute_renderer_torch import tracing
from compute_renderer_torch.backends import (
    binning, common, front, micro, raster, texture,
)

F32 = torch.float32

# Triangle-count split between the tile and micro paths, and the chunk size
# of the tile path's multi-pass depth merge. Both come from the TPU's 16 MiB
# VMEM budget for the resident coefficient table (12 MiB / 128 B per
# triangle = 98,304; a 44-column table chunks at 71,493); they are kept as
# plain tunables so that the two packages split scenes and chunks alike,
# and are to be decided again by measurement on the card.
MAX_TRI_TABLE_BYTES = 12 * 1024 * 1024
TILE_PATH_MAX_TRIANGLES = MAX_TRI_TABLE_BYTES // (raster.TRI_TABLE_WIDTH * 4)

# Per-tile list cap ceiling. The JAX package's bound is its SMEM window;
# the raster kernel here streams lists of any length, but the cap is kept
# so that the overflow and retry behaviour matches the reference.
MAX_TILE_CAP = 8192


def choose_tile(num_triangles: int, width: int, height: int) -> tuple:
    """Framebuffer tile shape of a direct ``render_frame`` call and of a
    renderer that does not tune it: (16, 256). The renderer times
    ``TILE_CANDIDATES`` per scene and size on the card
    (``Renderer._maybe_tune_tile``)."""
    del num_triangles, width, height
    return 16, 256


# The tile shapes the renderer's tuner times (the JAX package's
# tpu.TILE_CANDIDATES): plain, wave and edge-melt frames are the same image
# at either, so the pick is a matter of speed alone.
TILE_CANDIDATES = ((16, 256), (8, 128))


def resolve_path(path: str, num_triangles: int, tri_chunk: int = 0) -> str:
    """'auto' picks the micro path above the tile path's triangle split."""
    if path != "auto":
        return path
    return "micro" if num_triangles > (tri_chunk or TILE_PATH_MAX_TRIANGLES) \
        else "tile"


def default_caps(path: str, num_triangles: int, width: int, height: int,
                 tile_h: int = 0, tile_w: int = 0) -> dict:
    """Default binning capacities {"pair_cap", "tile_cap", "tile_h",
    "tile_w"} — the one starting point the renderer's retry grows from.
    The micro path has no per-tile cap (``tile_cap`` None) and a fixed
    8x128 tile."""
    T = max(num_triangles, 1)
    if path == "micro":
        ntx_t = (width + 127) // 128
        nty_t = (height + 7) // 8
        return {
            "pair_cap": binning.default_pair_cap_micro(T, ntx_t * nty_t * 16),
            "tile_cap": None,
            "tile_h": 8,
            "tile_w": 128,
        }
    if tile_h == 0 or tile_w == 0:
        tile_h, tile_w = choose_tile(T, width, height)
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h
    return {
        "pair_cap": binning.default_pair_cap(T, ntx * nty),
        "tile_cap": min(binning.default_tile_cap(T, width, height, tile_h,
                                                 tile_w), MAX_TILE_CAP),
        "tile_h": tile_h,
        "tile_w": tile_w,
    }


def grow_pair_cap(cur: int, needed: int) -> int:
    """Next pair_cap for a reported need: the need plus 12.5% slack,
    1024-aligned, never shrinking."""
    return max((needed + needed // 8 + 1023) // 1024 * 1024, cur)


def grow_tile_cap(cur: int, needed: int, tile_h: int, tile_w: int) -> int:
    """Next tile_cap for a reported need (8-aligned, 12.5% slack); a clear
    error past ``MAX_TILE_CAP``."""
    if needed > MAX_TILE_CAP:
        raise RuntimeError(
            f"scene needs {needed} triangles in one {tile_h}x{tile_w} tile "
            f"list; the cap is MAX_TILE_CAP={MAX_TILE_CAP} (use the micro "
            "path, path='micro' or 'auto')")
    grown = (needed + needed // 8 + 7) // 8 * 8
    return max(min(grown, MAX_TILE_CAP), cur)


def corner_soa(vertex_attr, tri):
    """(N, C) per-vertex rows + (T, 3) indices -> (3 corners, C, T)."""
    return vertex_attr[tri.long()].permute(1, 2, 0).contiguous()


def texf_eligible(tex_table) -> bool:
    """Fused texturing carries TextureInfo offsets as f32 columns of the
    coefficient table: exact only below 2^24 texels (tpu.py:485-490)."""
    t = np.asarray(tex_table)
    return t.size == 0 or int(t[:, 0].max()) < common.TEXF_MAX_OFFSET


TEX_FILTERS = ("nearest", "bilinear") + common.MIP_FILTERS
TEX_MODES = ("fused", "deferred")
# The spans around a frame's texture work: the per-frame
# vertex stage and mip rows before the raster, the tail after it.
TEXTURE_RANGES = ("texture_setup", "texture_tail")
# The texture stages' kernels (``texture.py``) in each range. They launch
# from their own library, outside any torch op, so a profile finds them
# by name, not under the range.
TEXTURE_RANGE_KERNELS = {
    "texture_setup": ("mip_rows_kernel", "vertex_stage_kernel"),
    "texture_tail": ("texture_tail_kernel", "texture_tail_mip_kernel",
                     "deferred_tail_kernel"),
}


def check_texture_options(tex_filter: str, tex_mode: str) -> None:
    """The one check of the texture options: an unknown filter or mode
    raises ``ValueError``."""
    if tex_filter not in TEX_FILTERS:
        raise ValueError(f"unknown tex_filter {tex_filter!r}")
    if tex_mode not in TEX_MODES:
        raise ValueError(f"unknown tex_mode {tex_mode!r}")


def frame_mode(face_kd, texels, tex_filter: str, tex_mode: str) -> str:
    """The kernels' mode for a frame (tpu.py:196-206, :618-627): a textured
    frame (``texels`` given) is fused — ``texf``, or ``texf_mip`` under a
    mip filter — unless ``tex_mode`` is "deferred" (``vis``); an
    untextured one is ``mat`` with ``face_kd``, else ``base``."""
    if texels is None:
        return "mat" if face_kd is not None else "base"
    if tex_mode == "deferred":
        return "vis"
    return "texf_mip" if tex_filter in common.MIP_FILTERS else "texf"


def _frame_texture(mode, positions, tri, view_proj, effect, width, height,
                   face_kd, uvs, uv_soa, tex_rows, face_tex, tex_mips,
                   tex_filter):
    """What the deferred tail reads (vis only, else None): the per-vertex
    (world, screen) of ``texture.vertex_stage`` and the frame's mip rows
    (``texture.mip_rows``; None under nearest and bilinear); and the front
    end's mode inputs: kd rows, uv corners and the TextureInfo rows (texf)
    or the frame's mip rows (texf_mip). The vis table is the base one (kd
    applies in the tail)."""
    if mode == "mat":
        return None, {"kd_rows": face_kd}
    if mode == "texf":
        return None, {"kd_rows": face_kd, "uv_soa": uv_soa,
                      "tex_rows": tex_rows}
    if mode == "base":
        return None, {}
    with tracing.span(TEXTURE_RANGES[0]):
        rows = None
        if tex_filter in common.MIP_FILTERS:
            rows = texture.mip_rows(positions, tri, uvs, face_tex, tex_mips,
                                    view_proj, effect, width, height,
                                    tex_filter)
        if mode == "texf_mip":
            return None, {"kd_rows": face_kd, "uv_soa": uv_soa,
                          "mip_rows": rows}
        world, screen = texture.vertex_stage(positions, view_proj, effect,
                                             width, height)
        return (world, screen, rows), {}


def render_frame(positions, normals, tri, view_proj, view_position,
                 light_world_pos, light_color, light_intensity, effect, *,
                 width: int, height: int, tile_h: int = 0, tile_w: int = 0,
                 pair_cap: int = 0, tile_cap: int = 0, tri_chunk: int = 0,
                 path: str = "auto", pos_soa=None, nrm_soa=None,
                 face_kd=None, texels=None, tex_filter: str = "nearest",
                 tex_mode: str = "fused", uv_soa=None, tex_rows=None,
                 uvs=None, face_tex=None, tex_table=None, tex_mips=None,
                 acc=None):
    """Render one frame on the path ``resolve_path`` picks (the micro path
    is ``render_frame_micro``); returns ((H, W, 4) u8 RGBA,
    depth key (H, W) u32, overflow (2,) i32 = [pair_cap_needed,
    tile_cap_needed], 0 meaning within capacity).

    ``face_kd`` (T, 3) selects the material mode; ``texels`` a texture
    mode (``frame_mode``) filtered by ``tex_filter``, with what that mode
    reads: ``uv_soa`` (3 corners, 2, T) and ``tex_rows`` (T, 3) (texf);
    ``uv_soa``, ``uvs`` (N, 2), ``face_tex`` (T,) and ``tex_mips`` (M, L,
    3) with ``texels`` the mip pool (texf_mip); ``uvs``, ``face_tex`` and
    ``tex_table`` (M, 3) or ``tex_mips`` (vis). ``mesh_ext_tensors``
    builds and checks these from a mesh.

    Scenes above ``tri_chunk`` triangles (only with ``path="tile"``
    forced; 0 sizes the chunk for the mode's table width) render in
    triangle chunks merged by depth key — the same image as one pass
    (strict < keeps the lowest index on ties; a G-buffer merges
    channel-wise, vis ids are offset by the chunk first). ``pos_soa`` /
    ``nrm_soa`` are the (3, 3, T) corner-SoA geometry, built from ``tri``
    when absent. ``acc`` (7,) int64, or None, takes the binning's fold of
    every chunk: the needs and the longest list by max, the pairs and
    occupied tiles by sum; on the micro path the raster adds its samples,
    and in the texf_mip mode the tail its textured pixels."""
    device = positions.device
    T = int(tri.shape[0])
    if T == 0:
        rgba, key = common.empty_frame(width, height, device)
        return rgba, key, torch.zeros((2,), dtype=torch.int32, device=device)
    tex = dict(face_kd=face_kd, texels=texels, tex_filter=tex_filter,
               tex_mode=tex_mode, uv_soa=uv_soa, tex_rows=tex_rows, uvs=uvs,
               face_tex=face_tex, tex_table=tex_table, tex_mips=tex_mips)
    if resolve_path(path, T, tri_chunk) == "micro":
        return render_frame_micro(
            positions, normals, tri, view_proj, view_position,
            light_world_pos, light_color, light_intensity, effect,
            width=width, height=height, pair_cap=pair_cap, pos_soa=pos_soa,
            nrm_soa=nrm_soa, acc=acc, **tex)
    mode = frame_mode(face_kd, texels, tex_filter, tex_mode)
    if tri_chunk == 0:
        # Chunks sized for the table this mode builds (tpu.py:628-641).
        tri_chunk = MAX_TRI_TABLE_BYTES // (raster.MODE_WIDTHS[mode] * 4)
    if tile_h == 0 or tile_w == 0:
        tile_h, tile_w = choose_tile(T, width, height)
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h

    if pos_soa is None:
        pos_soa = corner_soa(positions.to(F32), tri)
    if nrm_soa is None:
        nrm_soa = corner_soa(normals.to(F32), tri)
    view_position = view_position.to(F32)
    vertex, front_kw = _frame_texture(
        mode, positions, tri, view_proj, effect, width, height, face_kd,
        uvs, uv_soa, tex_rows, face_tex, tex_mips, tex_filter)
    table, meta = front.front_end(pos_soa, nrm_soa, view_proj, effect,
                                  width=width, height=height, tile_h=tile_h,
                                  tile_w=tile_w, **front_kw)

    out_p = key_p = overflow = best = None
    for c0 in range(0, T, tri_chunk):
        c1 = min(c0 + tri_chunk, T)
        pc = pair_cap or binning.default_pair_cap(c1 - c0, ntx * nty)
        # Per-tile capacity from FULL-scene density: a chunk's triangles are
        # spatially clustered, so its own average underestimates its peaks.
        tc = tile_cap or min(
            binning.default_tile_cap(T, width, height, tile_h, tile_w),
            MAX_TILE_CAP)
        bins = binning.bin_tiles_meta(meta[:, c0:c1], ntx, nty, pc, tc,
                                      acc)
        pair_data = (bins["bin_rows"] if bins["layout"] == "dense"
                     else bins["pair_tri"])
        out_c, key_c = raster.raster_shade_tiles(
            table[c0:c1], pair_data, bins["seg_start"], bins["seg_count"],
            effect, view_position, light_world_pos, light_color,
            light_intensity, height_padded=nty * tile_h,
            width_padded=ntx * tile_w, tile_h=tile_h, tile_w=tile_w,
            layout=bins["layout"], mode=mode,
            worklist=(bins["worklist"], bins["k"]), spans=bins.get("spans"),
        )
        if out_c.dtype == torch.uint32:  # packed RGBA merges as int32
            out_c = out_c.view(torch.int32)
        if mode == "vis" and c0:
            # Chunk-local winner ids -> global triangle ids (tpu.py:767-769).
            out_c = torch.where(out_c >= 0, out_c + c0, out_c)
        if out_p is None:
            out_p, key_p, overflow = out_c, key_c, bins["overflow"]
            continue
        # A second chunk: merge by the u32 key, held in int64.
        if best is None:
            best = key_p.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        kc = key_c.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        win = kc < best  # a G-buffer merges channel-wise
        out_p = torch.where(win, out_c, out_p)
        key_p = torch.where(win, key_c.view(torch.int32),
                            key_p.view(torch.int32)).view(torch.uint32)
        best = torch.where(win, kc, best)
        overflow = torch.maximum(overflow, bins["overflow"])
    key = key_p[:height, :width]
    rgba = finish_frame(mode, out_p[..., :height, :width], key, tex, vertex,
                        tri, normals, effect, view_position, light_world_pos,
                        light_color, light_intensity, acc=acc)
    return rgba, key, overflow


def finish_frame(mode, out, key, tex, vertex, tri, normals, effect,
                 view_position, light_world_pos, light_color,
                 light_intensity, pair_tri=None, x_offset: int = 0,
                 y_offset: int = 0, acc=None):
    """Resolve the raster output: unpack RGBA, shade a G-buffer through
    its fused tail (with ``tex["texels_packed"]``, the u8-packed pool,
    when given), or run the deferred tail on the winners. On the micro
    path the vis ids are pair indices and ``pair_tri`` (its sorted pair
    list, a stripe's own on a sharded render) maps them to global
    triangle ids — the JAX package's ``tpu.micro_vis_tail``. The offsets
    place ``out``'s first pixel at its global coordinates (a stripe of a
    sharded render), for the deferred tail's sample positions. The mip
    tail adds the pixels it shaded from an image to ``acc`` (or None)."""
    if mode in ("base", "mat"):
        return raster.unpack_rgba(out)
    with tracing.span(TEXTURE_RANGES[1]):
        lc, li = light_color.to(F32), light_intensity.to(F32)
        if mode == "texf":
            return texture.texture_tail(
                out, key, tex["texels"], lc, li,
                tex_filter=tex["tex_filter"],
                texels_packed=tex.get("texels_packed"))
        if mode == "texf_mip":
            return texture.texture_tail_mip(
                out, key, tex["texels"], tex["tex_mips"], lc, li,
                tex_filter=tex["tex_filter"], acc=acc)
        # The deferred tail (tpu.py:801-817; the micro path's is
        # tpu.micro_vis_tail, whose 3T virtual corner vertices hold the
        # floats the per-vertex arrays give through ``tri``).
        world, screen, rows = vertex
        return texture.deferred_tail(
            out, key, tri, screen, world, normals, tex["uvs"], effect,
            tex["face_kd"], tex["face_tex"], tex["texels"], tex["tex_table"],
            view_position, light_world_pos, lc, li,
            tex_filter=tex["tex_filter"], tex_mips=tex["tex_mips"],
            rows=rows, pair_tri=pair_tri, x_offset=x_offset,
            y_offset=y_offset)


def render_frame_micro(positions, normals, tri, view_proj, view_position,
                       light_world_pos, light_color, light_intensity, effect,
                       *, width: int, height: int, pair_cap: int = 0,
                       pos_soa=None, nrm_soa=None, face_kd=None,
                       texels=None, tex_filter: str = "nearest",
                       tex_mode: str = "fused", uv_soa=None, tex_rows=None,
                       uvs=None, face_tex=None, tex_table=None,
                       tex_mips=None, acc=None):
    """Render one nonempty frame on the micro path (``render_frame``
    dispatches here); the same contract and modes as ``render_frame``
    (the overflow report's tile entry is always 0: there is no per-tile
    cap). Coverage outside a triangle's bbox (voxelize, mirage) clips to
    the 8x8 cell rectangles."""
    tex = dict(face_kd=face_kd, texels=texels, tex_filter=tex_filter,
               tex_mode=tex_mode, uv_soa=uv_soa, tex_rows=tex_rows, uvs=uvs,
               face_tex=face_tex, tex_table=tex_table, tex_mips=tex_mips)
    mode = frame_mode(face_kd, texels, tex_filter, tex_mode)
    T = int(tri.shape[0])
    ntx = (width + 127) // 128
    nty = (height + 7) // 8
    pair_cap = pair_cap or binning.default_pair_cap_micro(T, ntx * nty * 16)
    if pos_soa is None:
        pos_soa = corner_soa(positions.to(F32), tri)
    if nrm_soa is None:
        nrm_soa = corner_soa(normals.to(F32), tri)
    vertex, front_kw = _frame_texture(
        mode, positions, tri, view_proj, effect, width, height, face_kd,
        uvs, uv_soa, tex_rows, face_tex, tex_mips, tex_filter)
    table, meta = front.front_end(pos_soa, nrm_soa, view_proj, effect,
                                  width=width, height=height, tile_h=8,
                                  tile_w=8, **front_kw)
    bins = binning.bin_cells_sort_meta(meta[3], meta[2], meta[0], meta[1],
                                       ntx, nty, pair_cap, acc)
    out_p, key_p = micro.raster_shade_micro(
        table, bins["pair_tri"], bins["seg_start"],
        bins["seg_count"], bins["tile_count"], effect,
        view_position.to(F32), light_world_pos, light_color,
        light_intensity, height_padded=nty * 8, width_padded=ntx * 128,
        mode=mode, worklist=(bins["worklist"], bins["k"]), acc=acc)
    overflow = bins["overflow"]
    key = key_p[:height, :width]
    rgba = finish_frame(mode, out_p[..., :height, :width], key, tex, vertex,
                        tri, normals, effect, view_position.to(F32),
                        light_world_pos, light_color, light_intensity,
                        pair_tri=bins["pair_tri"], acc=acc)
    return rgba, key, overflow


def mesh_ext_tensors(mesh, tri, device, *, tex_filter: str = "nearest",
                     tex_mode: str = "fused"):
    """The mesh's material / texture inputs of ``render_frame`` on
    ``device``, uploaded once, with the JAX engine's decisions
    (tpu.py:886-927, engine/renderer.py:122-191): ``face_kd``; for a
    textured mesh ``texels``, ``tex_filter``, ``tex_mode``, ``uvs``,
    ``face_tex`` and ``tex_table``, plus what its mode reads — the uv
    corners and TextureInfo rows (``common.tex_rows_f32``) for texf, the
    uv corners for texf_mip. The mip filters replace ``texels`` by the
    mip pool and add its level table ``tex_mips``, both built here on the
    host (``io.textures.trilinear_tex_arrays``); nearest and bilinear
    take the deferred mode for atlases of 2^24 texels or more
    (``texf_eligible``). Checks the options (``check_texture_options``)."""
    def dev(a, dtype=F32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    check_texture_options(tex_filter, tex_mode)
    ext = {}
    if mesh.face_kd is not None:
        ext["face_kd"] = dev(mesh.face_kd)
    if not mesh.has_textures:
        return ext
    mip = tex_filter in common.MIP_FILTERS
    if not (mip or texf_eligible(mesh.tex_table)):
        tex_mode = "deferred"
    texels = mesh.texels
    if mip:
        from compute_renderer_torch.io.textures import trilinear_tex_arrays

        texels, mips = trilinear_tex_arrays(mesh.texels, mesh.tex_table)
        ext["tex_mips"] = dev(mips, torch.int32)
    face_tex = dev(mesh.face_tex, torch.int32)
    tex_table = dev(mesh.tex_table, torch.int32)
    ext.update(texels=dev(texels), tex_filter=tex_filter, tex_mode=tex_mode,
               uvs=dev(mesh.uvs), face_tex=face_tex, tex_table=tex_table)
    if tex_mode == "fused":
        ext["uv_soa"] = corner_soa(ext["uvs"], tri)
        if not mip:
            ext["tex_rows"] = common.tex_rows_f32(face_tex, tex_table)
    return ext


def frame_tensors(mesh, camera_uniform, lights, effect, device, *,
                  tex_filter: str = "nearest", tex_mode: str = "fused"):
    """One frame's inputs on ``device``: ``render_frame``'s positional
    arguments (positions, normals, tri, view_proj, view_position, the
    three light arrays, effect) and the mesh's ``mesh_ext_tensors``."""
    def dev(a, dtype=F32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    light_world_pos, light_color, light_intensity = lights
    tri = dev(mesh.indices.astype(np.int32), torch.int32).reshape(-1, 3)
    args = (
        dev(mesh.positions), dev(mesh.normals), tri,
        dev(camera_uniform.view_proj), dev(camera_uniform.view_position),
        dev(light_world_pos), dev(light_color), dev(light_intensity),
        dev(effect),
    )
    return args, mesh_ext_tensors(mesh, tri, device, tex_filter=tex_filter,
                                  tex_mode=tex_mode)


def render(mesh, camera_uniform, lights, effect, width, height, *,
           device="cuda", tile_h: int = 0, tile_w: int = 0,
           pair_cap: int = 0, tile_cap: int = 0, max_retries: int = 3,
           path: str = "auto", tex_filter: str = "nearest",
           tex_mode: str = "fused"):
    """Host-level entry with capacity retry: an overflowing frame is
    rendered again at the reported need (on the micro path only
    ``pair_cap`` grows). Under ``path="auto"``, a tile list past
    ``MAX_TILE_CAP`` falls back to the micro path, as tpu.render does.
    The mesh's ``face_kd`` and textures select the mode. Returns (H, W, 4)
    u8 numpy. ``device="cuda"`` (the default) runs the kernels,
    ``device="cpu"`` their twins."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("cuda.render(device='cuda') needs an NVIDIA GPU "
                           "with CUDA; pass device='cpu' for the twins")
    T = max(mesh.indices.shape[0] // 3, 1)
    requested_path = path
    path = resolve_path(path, T)
    caps = default_caps(path, T, width, height, tile_h, tile_w)
    pc = pair_cap or caps["pair_cap"]
    tc = tile_cap or caps["tile_cap"]
    tile_h, tile_w = caps["tile_h"], caps["tile_w"]
    args, ext = frame_tensors(mesh, camera_uniform, lights, effect, device,
                              tex_filter=tex_filter, tex_mode=tex_mode)
    for _ in range(max_retries):
        rgba, _, overflow = render_frame(
            *args, width=width, height=height, tile_h=tile_h, tile_w=tile_w,
            pair_cap=pc, tile_cap=tc, path=path, **ext)
        flags = overflow.cpu().numpy()
        if not flags.any():
            return rgba.cpu().numpy()
        if (flags[1] > MAX_TILE_CAP and path != "micro"
                and requested_path == "auto"):
            path = "micro"
            pc = pair_cap or default_caps("micro", T, width,
                                          height)["pair_cap"]
            continue
        if flags[0]:
            pc = grow_pair_cap(pc, int(flags[0]))
        if flags[1]:
            tc = grow_tile_cap(tc, int(flags[1]), tile_h, tile_w)
    raise RuntimeError(
        f"binning capacity overflow after {max_retries} retries "
        f"(path={path}, pair_cap={pc}, tile_cap={tc})")
