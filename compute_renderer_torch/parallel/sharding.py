"""Framebuffer stripes and sort-middle over a ``torch.distributed`` group.

Counterpart of the JAX package's ``parallel/sharding.py``. There a 1-D
mesh axis shards the framebuffer's tile rows inside ``shard_map``; here
each rank of a group is a process that calls ``render_frame_sharded``
with the same (replicated) inputs, renders its own horizontal stripe, and
the stripes are gathered. Rank r of n owns tile rows ``[r * nty / n, (r +
1) * nty / n)``, ``nty`` padded to a multiple of n, and renders them at
its global row offset (``y_offset``: the rasters' row offset param, the
deferred tail's ``pixel_grid``), so that the mirage warp and every sample
position are the full frame's and each stripe is bitwise the single-device
frame's rows. Three decompositions (``path``):

- **tile stripes** (``_stripe_tile``, JAX ``_stripe_render``): the front
  over the whole screen at the tile shape the single-device renderer
  uses, the covered tile rows clipped to the stripe, ``binning``, and
  ``csrc/raster.cu`` over the stripe's tiles;
- **micro stripes** (``_stripe_micro``, JAX ``_stripe_render_micro``):
  the front at 8x8 cells, each triangle's cell rows clipped to the stripe
  in its meta (exact integers), the expansion kernel, one stable sort,
  ``csrc/micro.cu``. (The JAX stripe expands with XLA ops to dodge an
  XLA:CPU FMA artefact; the expansion kernel here is integer-exact.)
- **sort-middle** (``_stripe_sortmiddle``, JAX
  ``_stripe_render_sortmiddle``): rank r takes the triangle slice ``[r Tl,
  (r + 1) Tl)``, ``Tl = ceil(T / n)``, and runs the front, the expansion
  and the cell sort on that slice only; buckets of at most ``bucket_cap``
  pairs go to their stripes' ranks in three ``all_to_all``s (cells,
  triangles, counts); the receiver restores ascending triangle order in
  each cell with one sort of a composite ``(cell, tri)`` key
  (``sort_cell_tri``), which the micro raster's (key, pair) minimum needs
  to pick the single device's winner; one ``all_gather`` assembles the
  ``(n Tl, R)`` coefficient table from the slices the fronts wrote.
  Triangle ids are global (``r Tl + local``). The deferred tail (vis)
  resolves winners from the per-vertex screen and world stage, computed
  on every rank (the JAX package gathers per-slice corner arrays).

A rank's overflow report is all-reduced with MAX, so every rank grows
its capacities alike in ``render_sharded`` (the retrying host entry) and
the next collective never waits for a rank that diverged. Each rank has
its own ``common.merge_scratch``: ranks are processes, and one process
renders one stripe at a time.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from compute_renderer_torch.backends import (
    binning, common, cuda, expand, front, micro, raster,
)
from compute_renderer_torch.engine.renderer import box_downsample
from compute_renderer_torch.parallel import group as grp

F32 = torch.float32
I32 = torch.int32
PATHS = ("auto", "tile", "micro", "sortmiddle")


def make_mesh(n_devices: int | None = None):
    """The 1-D group of the first ``n_devices`` ranks of the default group
    (all of them when None): what the JAX package's ``make_mesh`` is to a
    device mesh. Every rank of the default group calls it; a rank outside
    the group gets ``dist.GroupMember.NON_GROUP_MEMBER``."""
    world = dist.get_world_size()
    if n_devices is None or n_devices == world:
        return dist.group.WORLD
    return dist.new_group(list(range(n_devices)))


def _check_ssaa_stripes(ssaa: int, stripe_h: int, padded_w: int) -> None:
    """A stripe resolves its own SSAA blocks, which must not cross a
    stripe (or the padding)."""
    if ssaa > 1 and (stripe_h % ssaa or padded_w % ssaa):
        raise ValueError(
            f"ssaa={ssaa} does not divide the stripe geometry "
            f"(stripe_h={stripe_h}, padded_w={padded_w}); use a power-of-2 "
            "factor or the single-device/frame-parallel path")


def sort_cell_tri(cell, tri, tri_bound: int):
    """(cell, tri) pairs sorted lexicographically, by one sort of the
    int64 key ``cell * tri_bound + tri`` (0 <= tri < tri_bound): torch has
    no multi-key sort. Equal keys are equal pairs, so the unstable sort's
    values are deterministic."""
    key = torch.sort(cell.long() * tri_bound + tri.long()).values
    return ((key // tri_bound).to(I32), (key % tri_bound).to(I32))


def _clip_rows(y0, y1, row0: int, rows: int):
    """Covered row ranges [y0, y1) clipped to the stripe's rows [row0,
    row0 + rows), in stripe-local rows."""
    return (torch.clamp(y0 - row0, 0, rows).to(I32),
            torch.clamp(y1 - row0, 0, rows).to(I32))


def _stripe_meta(meta, row0: int, rows: int):
    """The front end's meta (4, T) = [x0, y0, rx, c] with each triangle's
    rows clipped to the stripe [row0, row0 + rows), in stripe-local rows:
    cover count ``rx * rows`` of the clipped rows, 0 where none is left."""
    x0, y0, rx, c = meta[0], meta[1], meta[2], meta[3]
    ry = torch.div(c, torch.clamp(rx, min=1), rounding_mode="floor")
    ly0, ly1 = _clip_rows(y0, y0 + ry, row0, rows)
    c = torch.where(ly1 > ly0, rx * (ly1 - ly0), 0).to(I32)
    return torch.stack([x0.to(I32), ly0, rx.to(I32), c])


def _stripe_tile(g, rank, n, *, rw, rh, tile_h, tile_w, pair_cap, tile_cap,
                 mode, front_kw):
    """Tile stripe ``rank`` of ``n``: (out, key, overflow, y_offset,
    pair_tri=None) of its (nty / n * tile_h, ntx * tile_w) rows."""
    T = g["tri"].shape[0]
    ntx = (rw + tile_w - 1) // tile_w
    nty = -(-((rh + tile_h - 1) // tile_h) // n) * n  # equal stripes
    rows = nty // n
    row0 = rank * rows
    table, meta = front.front_end(g["pos_soa"], g["nrm_soa"], g["view_proj"],
                                  g["effect"], width=rw, height=rh,
                                  tile_h=tile_h, tile_w=tile_w, **front_kw)
    pc = pair_cap or binning.default_pair_cap(T, ntx * nty)
    tc = tile_cap or min(binning.default_tile_cap(T, rw, rh, tile_h, tile_w),
                         cuda.MAX_TILE_CAP)
    bins = binning.bin_tiles_meta(_stripe_meta(meta, row0, rows), ntx, rows,
                                  pc, tc)
    pair_data = (bins["bin_rows"] if bins["layout"] == "dense"
                 else bins["pair_tri"])
    y_offset = row0 * tile_h
    out, key = raster.raster_shade_tiles(
        table, pair_data, bins["seg_start"], bins["seg_count"], g["effect"],
        g["view_position"], *g["lights"], height_padded=rows * tile_h,
        width_padded=ntx * tile_w, tile_h=tile_h, tile_w=tile_w,
        layout=bins["layout"], mode=mode, y_offset=y_offset,
        worklist=(bins["worklist"], bins["k"]), spans=bins.get("spans"))
    return out, key, bins["overflow"], y_offset, None


def _stripe_micro(g, rank, n, *, rw, rh, pair_cap, mode, front_kw):
    """Micro stripe ``rank`` of ``n``: the 8x8-cell meta of the whole
    screen with each triangle's cell rows clipped to the stripe (cover
    count ``rx * rows``), expanded, sorted and rastered at the stripe's
    row offset."""
    T = g["tri"].shape[0]
    ntx = (rw + 127) // 128
    nty = -(-((rh + 7) // 8) // n) * n
    rows = nty // n
    row0 = rank * rows
    table, meta = front.front_end(g["pos_soa"], g["nrm_soa"], g["view_proj"],
                                  g["effect"], width=rw, height=rh, tile_h=8,
                                  tile_w=8, **front_kw)
    x0, ly0, rx, c = _stripe_meta(meta, row0, rows)
    pc = pair_cap or binning.default_pair_cap_micro(T, ntx * nty * 16)
    bins = binning.bin_cells_sort_meta(c, rx, x0, ly0, ntx, rows, pc)
    y_offset = row0 * 8
    out, key = micro.raster_shade_micro(
        table, bins["pair_tri"], bins["seg_start"], bins["seg_count"],
        bins["tile_count"], g["effect"], g["view_position"], *g["lights"],
        height_padded=rows * 8, width_padded=ntx * 128, mode=mode,
        y_offset=y_offset, worklist=(bins["worklist"], bins["k"]))
    return out, key, bins["overflow"], y_offset, bins["pair_tri"]


def _slice_rows(a, dim: int, start: int, stop: int, length: int, fill=0):
    """``a``'s triangle rows [start, stop) along ``dim``, padded with
    ``fill`` to ``length`` rows (None stays None)."""
    if a is None:
        return None
    part = a.narrow(dim, start, stop - start)
    if stop - start == length:
        return part
    shape = list(a.shape)
    shape[dim] = length - (stop - start)
    return torch.cat([part, torch.full(shape, fill, dtype=a.dtype,
                                       device=a.device)], dim=dim)


def _stripe_sortmiddle(g, rank, n, group, *, rw, rh, pair_cap, bucket_cap,
                       mode, tex):
    """Sort-middle stripe ``rank`` of ``n`` (module docstring): the
    slice's front, expansion and sort, the pair exchange, the (cell, tri)
    re-sort, the table gather and the stripe's micro raster. Its overflow
    report is [the slice's pairs past ``pair_cap``, the largest bucket
    past ``bucket_cap``]."""
    device = g["pos_soa"].device
    T = g["tri"].shape[0]
    Tl = -(-T // n)
    start, stop = min(rank * Tl, T), min((rank + 1) * Tl, T)
    ntx = (rw + 127) // 128
    nty = -(-((rh + 7) // 8) // n) * n
    rows = nty // n
    per_stripe = ntx * rows * 16  # cells of a stripe (cell ids are global)
    num_cells = per_stripe * n

    # The slice's front; padding rows are (0, 0, 0) triangles, dropped by
    # their cover count (under voxelize they could pass the facing test).
    front_kw = {}
    if mode != "vis":  # the vis table is the base one
        _, front_kw = cuda._frame_texture(
            mode, g["positions"], _slice_rows(g["tri"], 0, start, stop, Tl),
            g["view_proj"], g["effect"], rw, rh,
            _slice_rows(tex["face_kd"], 0, start, stop, Tl),
            tex["uvs"], _slice_rows(tex["uv_soa"], 2, start, stop, Tl),
            _slice_rows(tex["tex_rows"], 0, start, stop, Tl),
            _slice_rows(tex["face_tex"], 0, start, stop, Tl, fill=-1),
            tex["tex_mips"], tex["tex_filter"])
    table_l, meta = front.front_end(
        _slice_rows(g["pos_soa"], 2, start, stop, Tl),
        _slice_rows(g["nrm_soa"], 2, start, stop, Tl), g["view_proj"],
        g["effect"], width=rw, height=rh, tile_h=8, tile_w=8, **front_kw)
    live = torch.arange(Tl, device=device) < stop - start
    c = torch.where(live, meta[3], 0).to(I32)
    cell, tri_loc, total = expand.expand_cells(
        c, meta[2], meta[0], meta[1], pair_cap=pair_cap, ntx_t=ntx,
        num_cells=num_cells)
    sorted_cell, order = torch.sort(cell, stable=True)
    sorted_tri = (tri_loc + rank * Tl)[order]

    # Buckets by destination stripe: the sorted list is stripe-contiguous.
    bounds = torch.searchsorted(
        sorted_cell, torch.arange(n + 1, dtype=I32, device=device)
        * per_stripe, out_int32=True)
    send_counts = bounds[1:] - bounds[:-1]
    bucket_needed = send_counts.max()
    slot = torch.arange(bucket_cap, device=device)
    idx = (bounds[:-1, None].long() + slot[None]).reshape(-1)
    cell_pad = torch.cat([sorted_cell, torch.full((bucket_cap,), num_cells,
                                                  dtype=I32, device=device)])
    tri_pad = torch.cat([sorted_tri, torch.zeros((bucket_cap,), dtype=I32,
                                                 device=device)])
    recv_cell = torch.empty((n * bucket_cap,), dtype=I32, device=device)
    recv_tri = torch.empty_like(recv_cell)
    recv_counts = torch.empty((n,), dtype=I32, device=device)
    grp.all_to_all(recv_cell, cell_pad[idx], group)
    grp.all_to_all(recv_tri, tri_pad[idx], group)
    grp.all_to_all(recv_counts, torch.clamp(send_counts, max=bucket_cap),
                   group)

    # The stripe's pairs in (cell, tri) order; empty slots sort last.
    valid = slot[None] < recv_counts[:, None]
    cell_local = torch.where(valid, recv_cell.view(n, -1) - rank * per_stripe,
                             per_stripe).reshape(-1)
    tri_recv = torch.where(valid, recv_tri.view(n, -1), 0).reshape(-1)
    s_cell, s_tri = sort_cell_tri(cell_local, tri_recv, n * Tl)
    seg_start, seg_count, tile_count, _ = binning.segments_from_sorted_cells(
        s_cell, per_stripe, ntx * rows)

    # The (n Tl, R) table from the slices' rows, in the kernels' layout.
    stride = raster.table_stride(table_l.shape[1])
    storage = torch.empty((n * Tl, stride), dtype=F32, device=device)
    grp.all_gather(storage, torch.as_strided(table_l, (Tl, stride),
                                             (stride, 1)), group)
    table = storage[:, :table_l.shape[1]]
    y_offset = rank * rows * 8
    out, key = micro.raster_shade_micro(
        table, s_tri, seg_start, seg_count, tile_count, g["effect"],
        g["view_position"], *g["lights"], height_padded=rows * 8,
        width_padded=ntx * 128, mode=mode, y_offset=y_offset)
    overflow = torch.stack([
        torch.where(total > pair_cap, total, 0),
        torch.where(bucket_needed > bucket_cap, bucket_needed, 0)]).to(I32)
    return out, key, overflow, y_offset, s_tri


def render_frame_sharded(positions, normals, tri, view_proj, view_position,
                         light_world_pos, light_color, light_intensity,
                         effect, *, width: int, height: int, group=None,
                         path: str = "auto", tile_h: int = 0, tile_w: int = 0,
                         pair_cap: int = 0, tile_cap: int = 0,
                         bucket_cap: int = 0, ssaa: int = 1, pos_soa=None,
                         nrm_soa=None, face_kd=None, texels=None,
                         tex_filter: str = "nearest", tex_mode: str = "fused",
                         uv_soa=None, tex_rows=None, uvs=None, face_tex=None,
                         tex_table=None, tex_mips=None, texels_packed=None):
    """One frame rendered by the ranks of ``group`` (the default group
    when None), each calling this with the same inputs on its own device:
    ``cuda.render_frame``'s arguments (the mode inputs as there;
    ``texels_packed``, the u8-packed pool of ``io.textures.pack_pool_u8``,
    for the fused texf tail) plus ``path`` — "auto" (the single-device
    split between "tile" and "micro"), "tile", "micro" or "sortmiddle" —
    and ``bucket_cap`` (sort-middle: pairs a rank sends a stripe; 0 =
    ``pair_cap``). ``ssaa`` renders at ``ssaa`` x the size and each
    stripe resolves its own rows (block means of u8 values are exact in
    f32, so the stripes equal the single-device resolve). Returns, on
    every rank, ((height, width, 4) u8, depth keys (height * ssaa, width
    * ssaa) u32, overflow (2,) i32 = the MAX over the ranks of [pair_cap
    needed, tile_cap needed (tile) | 0 (micro) | bucket_cap needed
    (sortmiddle)], 0 = within capacity)."""
    rank, n = dist.get_rank(group), dist.get_world_size(group)
    T = int(tri.shape[0])
    device = positions.device
    rw, rh = width * ssaa, height * ssaa
    if path not in PATHS:
        raise ValueError(f"unknown path {path!r} (paths {PATHS})")
    if T == 0:
        rgba, key = common.empty_frame(rw, rh, device)
        return (box_downsample(rgba, ssaa), key,
                torch.zeros((2,), dtype=I32, device=device))
    if path != "sortmiddle":
        path = cuda.resolve_path(path, T)
    mode = cuda.frame_mode(face_kd, texels, tex_filter, tex_mode)
    if texels_packed is not None and mode != "texf":
        raise ValueError("texels_packed serves the fused nearest / bilinear "
                         f"tail (texf), not mode {mode!r}")
    tex = dict(face_kd=face_kd, texels=texels, tex_filter=tex_filter,
               tex_mode=tex_mode, uv_soa=uv_soa, tex_rows=tex_rows, uvs=uvs,
               face_tex=face_tex, tex_table=tex_table, tex_mips=tex_mips,
               texels_packed=texels_packed)
    g = dict(positions=positions, tri=tri, view_proj=view_proj,
             effect=effect, view_position=view_position.to(F32),
             lights=(light_world_pos, light_color, light_intensity),
             pos_soa=(pos_soa if pos_soa is not None
                      else cuda.corner_soa(positions.to(F32), tri)),
             nrm_soa=(nrm_soa if nrm_soa is not None
                      else cuda.corner_soa(normals.to(F32), tri)))
    if path == "tile":
        if T > cuda.TILE_PATH_MAX_TRIANGLES:
            raise ValueError(
                f"sharded tile-path rendering takes at most "
                f"{cuda.TILE_PATH_MAX_TRIANGLES} triangles in one table, "
                f"not {T}; use path='micro' (or 'auto')")
        if tile_h == 0 or tile_w == 0:
            tile_h, tile_w = cuda.choose_tile(T, rw, rh)
        nty = -(-((rh + tile_h - 1) // tile_h) // n) * n
        _check_ssaa_stripes(ssaa, nty // n * tile_h,
                            (rw + tile_w - 1) // tile_w * tile_w)
    else:
        nty = -(-((rh + 7) // 8) // n) * n
        _check_ssaa_stripes(ssaa, nty // n * 8, (rw + 127) // 128 * 128)
    vertex = front_kw = None
    if path != "sortmiddle" or mode == "vis":
        # Sort-middle builds its slice's mode inputs itself; the deferred
        # tail reads the whole per-vertex stage.
        vertex, front_kw = cuda._frame_texture(
            mode, positions, tri, view_proj, effect, rw, rh, face_kd, uvs,
            uv_soa, tex_rows, face_tex, tex_mips, tex_filter)
    if path == "tile":
        stripe = _stripe_tile(g, rank, n, rw=rw, rh=rh, tile_h=tile_h,
                              tile_w=tile_w, pair_cap=pair_cap,
                              tile_cap=tile_cap, mode=mode, front_kw=front_kw)
    elif path == "micro":
        stripe = _stripe_micro(g, rank, n, rw=rw, rh=rh, pair_cap=pair_cap,
                               mode=mode, front_kw=front_kw)
    else:
        ntx, Tl = (rw + 127) // 128, -(-T // n)
        pair_cap = pair_cap or binning.default_pair_cap_micro(
            Tl, ntx * nty * 16)
        stripe = _stripe_sortmiddle(
            g, rank, n, group, rw=rw, rh=rh, pair_cap=pair_cap,
            bucket_cap=bucket_cap or pair_cap, mode=mode, tex=tex)
    out, key, overflow, y_offset, pair_tri = stripe
    rgba = cuda.finish_frame(mode, out, key, tex, vertex, tri, normals,
                             effect, g["view_position"], *g["lights"],
                             pair_tri=pair_tri, y_offset=y_offset)
    rgba = box_downsample(rgba, ssaa)
    frame = torch.empty((n * rgba.shape[0],) + tuple(rgba.shape[1:]),
                        dtype=torch.uint8, device=device)
    grp.all_gather(frame, rgba, group)
    keys = torch.empty((n * key.shape[0], key.shape[1]), dtype=I32,
                       device=device)
    grp.all_gather(keys, key.view(I32), group)
    grp.all_reduce_max(overflow, group)
    return (frame[:height, :width], keys[:rh, :rw].view(torch.uint32),
            overflow)


def render_sharded(mesh, camera_uniform, lights, effect, width: int,
                   height: int, *, group=None, device="cuda",
                   max_retries: int = 3, path: str = "auto",
                   tile_h: int = 0, tile_w: int = 0, pair_cap: int = 0,
                   tile_cap: int = 0, bucket_cap: int = 0, ssaa: int = 1,
                   tex_filter: str = "nearest", tex_mode: str = "fused",
                   stats: dict | None = None):
    """The retrying host entry, called by every rank of ``group`` with the
    same ``Mesh`` and uniforms (``cuda.render``'s arguments): the frame's
    tensors on the rank's device (``group.rank_device``; the mip pool
    built for the mip filters, the deferred mode for atlases of 2^24
    texels or more, as ``cuda.mesh_ext_tensors`` decides), then
    ``render_frame_sharded`` until no rank overflows. The reports are
    already the MAX over the ranks, so every rank grows the caps alike:
    ``pair_cap`` and, by path, ``tile_cap`` or ``bucket_cap``; under
    ``path="auto"`` a tile list past ``cuda.MAX_TILE_CAP`` moves to micro
    stripes, as the single-device renderer falls back. Returns (rgba
    (height, width, 4) u8, keys (height * ssaa, width * ssaa) u32), numpy,
    on every rank. With ``stats`` (a dict), the path and the capacities
    of the frame that fitted, and the attempts it took, are written into
    it."""
    device = grp.rank_device(device, dist.get_rank())
    T = max(mesh.indices.shape[0] // 3, 1)
    requested = path
    if path != "sortmiddle":
        path = cuda.resolve_path(path, T)
    args, ext = cuda.frame_tensors(mesh, camera_uniform, lights, effect,
                                   device, tex_filter=tex_filter,
                                   tex_mode=tex_mode)
    n = dist.get_world_size(group)
    rw, rh = width * ssaa, height * ssaa

    def defaults(path):
        if path == "sortmiddle":
            return cuda.default_caps("micro", -(-T // n), rw, rh)
        return cuda.default_caps(path, T, rw, rh, tile_h, tile_w)

    caps = defaults(path)
    for attempt in range(1, max_retries + 1):
        pair_cap = pair_cap or caps["pair_cap"]
        tile_cap = tile_cap or caps["tile_cap"] or 0
        bucket_cap = bucket_cap or (pair_cap if path == "sortmiddle" else 0)
        rgba, keys, overflow = render_frame_sharded(
            *args, width=width, height=height, group=group, path=path,
            tile_h=tile_h, tile_w=tile_w, pair_cap=pair_cap,
            tile_cap=tile_cap, bucket_cap=bucket_cap, ssaa=ssaa, **ext)
        needed = overflow.cpu().numpy()
        if not needed.any():
            if stats is not None:
                stats.update(path=path, pair_cap=pair_cap, tile_cap=tile_cap,
                             bucket_cap=bucket_cap, attempts=attempt)
            return rgba.cpu().numpy(), keys.cpu().numpy()
        if needed[0]:
            pair_cap = cuda.grow_pair_cap(pair_cap, int(needed[0]))
        if needed[1] and path == "sortmiddle":
            bucket_cap = cuda.grow_pair_cap(bucket_cap, int(needed[1]))
        elif needed[1] and path == "tile":
            if needed[1] > cuda.MAX_TILE_CAP and requested == "auto":
                # Past the tile list cap at any legal cap: micro stripes,
                # whose capacities count cells (Renderer._switch_to_micro).
                path, pair_cap, tile_cap = "micro", 0, 0
                caps = defaults(path)
                continue
            tile_cap = cuda.grow_tile_cap(tile_cap, int(needed[1]),
                                          caps["tile_h"], caps["tile_w"])
    raise RuntimeError(
        f"sharded binning capacity overflow after {max_retries} retries "
        f"(path={path}, pair_cap={pair_cap}, tile_cap={tile_cap}, "
        f"bucket_cap={bucket_cap})")
