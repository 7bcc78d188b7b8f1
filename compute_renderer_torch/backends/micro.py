"""Micro raster + shade of the mega-scene path.

Counterpart of the JAX package's ``backends/pallas_micro.py``
(``raster_shade_micro``). The framebuffer is tiled 8x128, each tile holds
sixteen 8x8 cells, and each cell walks its own segment of the cell-sorted
pair list (``binning.bin_cells_sort_meta``) in pair order, evaluating only
its 64 pixels: the same coverage, depth key, strict-< running minimum (the
(key, pair)-lexicographic winner) and epilogues as the tile raster
(``raster.py``), in each of its modes: base, mat, texf and texf_mip, and
vis, where the output is the winner's absolute index in ``pair_tri``
(``raster.PAIR_IDX_CLEAR`` where no pair covers; ``pair_tri`` maps it to
the triangle). Cell c of tile (ti, tj) is pixels x in [128 tj + 8 c, +8),
y in [8 ti, +8) plus the row offset (``y_offset``).

The coefficient rows are read from the (T, R) table at ``pair_tri[p]``:
the JAX package's P-sized pair stream (``build_pair_coeffs``) and its
complex64 packing are TPU mechanics the port does not carry.

A CUDA tensor runs the hand-written kernel ``csrc/micro.cu``; a CPU tensor
runs ``raster_shade_micro_plain``. The kernel cuts a cell of more than
``SPAN`` pairs at the multiples of ``SPAN`` of the pair list and merges the
pieces exactly; ``raster_shade_micro_spans_plain`` is that decomposition
in torch, for the tests. It culls each pair to the 2x2 quads of its cell
that it can cover (``kept_quads_plain``: the exact rectangle cull of the
tile raster, ``raster.cull_rect_plain``, against the cell's four 4x4
quadrants, then the quads inside the quadrants kept) and tests only their
samples, or all 64 where a pair keeps more than ``WIDE`` quads;
``raster_shade_micro_culled_plain`` is that walk in torch, for the tests.
Given ``acc`` (``binning``'s accumulator), the kernel adds the samples it
tested to ``acc[4]``, and the twin the same count
(``samples_tested_plain``). The kernel's walk leaves each pixel's key and
winning pair (``ids_scratch`` outside vis mode); a second launch of the
same source shades them, one thread a pixel.
"""

from __future__ import annotations

import torch

from compute_renderer_torch import tracing

from compute_renderer_torch.backends import binning, common, raster

I32 = torch.int32
# The longest range of pairs a warp of the kernel walks, and the most
# quads of its cell a pair may keep and still be tested quad by quad
# (csrc/micro.cu).
SPAN = 128
WIDE = 4
# The walk's winners for the shading epilogue, per (device, Hp, Wp).
_IDS_SCRATCH: dict = {}


def raster_shade_micro_plain(tri_table, pair_tri, seg_start, seg_count,
                             params, lights, *, height_padded: int,
                             width_padded: int, mode: str = "base"):
    """The twin. Cell ids ``(cy * ntx + cx // 16) * 16 + cx % 16`` are the
    row-major ids of the (Hp/8, Wp/8) cell grid, and each cell's segment is
    its list in pair order, so the micro raster is the tile raster's twin
    at 8x8 tiles on the flat layout: vectorized over (pair, 64 cell
    pixels) with a ``scatter_reduce`` "amin" merge of the key and the
    first pair that reaches it. Returns (out, key) as in
    ``raster.raster_shade_tiles_plain``, vis ids as pair indices."""
    return raster.raster_shade_tiles_plain(
        tri_table, pair_tri, seg_start, seg_count, params, lights,
        height_padded=height_padded, width_padded=width_padded, tile_h=8,
        tile_w=8, layout="flat", mode=mode, pair_ids=True)


def raster_shade_micro_spans_plain(tri_table, pair_tri, seg_start,
                                   seg_count, params, lights, *,
                                   height_padded: int, width_padded: int,
                                   mode: str = "base", span: int = SPAN):
    """The kernel's decomposition of ``raster_shade_micro_plain``, in torch
    (tests only): a cell of more than ``span`` pairs is cut at the
    multiples of ``span`` of the pair list, and each piece walks its range
    alone; the pieces of a cell merge per pixel by an "amin" of the int64
    words ((key - 2^31) << 32) + pair — the (key, pair)-lexicographic
    minimum, the key's top bit flipped so that signed order is its
    unsigned order; an uncovered piece adds no word. Then the twin's
    epilogue. Equal to ``raster_shade_micro_plain`` bitwise."""
    device = tri_table.device
    i64 = torch.int64
    none = torch.iinfo(i64).max
    tiles, pair_cell, tri, pos = raster._tile_pairs(pair_tri, seg_start,
                                                    seg_count, "flat")
    px, py = raster._tile_samples(params, tiles, width_padded // 8, 8, 8)
    cov_min = torch.maximum(params[0], params[1])
    long_cell = seg_count[tiles].long()[pair_cell] > span
    piece = torch.where(long_cell, torch.div(pos, span, rounding_mode="floor")
                        + 1, 0)
    units, unit = torch.unique(pair_cell * (pair_tri.shape[0] + 1) + piece,
                               return_inverse=True)
    unit_cell = torch.div(units, pair_tri.shape[0] + 1, rounding_mode="floor")
    best, first = raster._walk_plain(tri_table, unit, tri, pos,
                                     px[unit_cell], py[unit_cell], cov_min)
    word = torch.where(best != common.DEPTH_CLEAR,
                       ((best - 2**31) << 32) + first, none)
    merged = torch.full((tiles.shape[0], 64), none, dtype=i64,
                        device=device).scatter_reduce(
        0, unit_cell[:, None].expand_as(word), word, "amin")
    hit = merged != none
    best = torch.where(hit, (merged >> 32) + 2**31, common.DEPTH_CLEAR)
    pair = torch.where(hit, merged & 0xFFFFFFFF, 0)
    return raster._frame_outputs(
        tri_table, tiles, best, pair_tri.long()[pair], pair, px, py, params,
        lights, height_padded=height_padded, width_padded=width_padded,
        tile_h=8, tile_w=8, mode=mode, no_id=raster.PAIR_IDX_CLEAR)


def _quad_pixels(device):
    """(16, 4): the cell pixels (row-major 8x8) of quad bit 4 qy + qx,
    sample columns 2 qx, 2 qx + 1 and rows 2 qy, 2 qy + 1, as the kernel
    numbers them."""
    b = torch.arange(16, device=device)
    col, row = 2 * (b % 4), 2 * (b // 4)
    return torch.stack([(row + j) * 8 + col + i for i in range(2)
                        for j in range(2)], 1)


def _quadrant_quads(h):
    """The quad bits of quadrant h = 2 hy + hx: quad columns 2 hx, 2 hx + 1
    and rows 2 hy, 2 hy + 1."""
    hx, hy = h % 2, h // 2
    return [4 * (2 * hy + j) + 2 * hx + i for j in range(2)
            for i in range(2)]


def kept_quads_plain(rows, px, py, pair_cell, cov_min):
    """(N, 16) bool: the quads (bit 4 qy + qx, as ``_quad_pixels``) of each
    pair's cell that its (N, R) table row may cover. ``px``, ``py``: the
    cells' (G, 64) sample positions; ``pair_cell`` indexes them. A quad is
    kept where ``raster.cull_rect_plain`` keeps the row against its
    quadrant's sample rectangle and then against its own (each the
    NaN-aware min and max of its samples, ``raster._nan_rect``)."""
    device = rows.device
    pix = _quad_pixels(device)
    valid = torch.ones((px.shape[0], 16), dtype=torch.bool, device=device)

    def cull(samples):
        x0, x1, y0, y1 = raster._nan_rect(px[:, samples], py[:, samples],
                                          valid[:, :samples.shape[0]])
        return raster.cull_rect_plain(rows, x0[pair_cell], x1[pair_cell],
                                      y0[pair_cell], y1[pair_cell], cov_min)

    kept = torch.stack([cull(pix[q]) for q in range(16)], 1)
    for h in range(4):
        quads = _quadrant_quads(h)
        kept[:, quads] &= cull(pix[quads].reshape(-1))[:, None]
    return kept


def samples_tested_plain(tri_table, pair_tri, seg_start, seg_count, params,
                         *, width_padded: int):
    """The kernel's count of the coverage samples it tests, as an int64
    scalar tensor: for each listed pair, 4 for each quad it keeps
    (``kept_quads_plain``), or 64 where it keeps more than ``WIDE`` and the
    kernel walks it warp-wide."""
    cells, pair_cell, tri, _ = raster._tile_pairs(pair_tri, seg_start,
                                                  seg_count, "flat")
    px, py = raster._tile_samples(params, cells, width_padded // 8, 8, 8)
    cov_min = torch.maximum(params[0], params[1])
    kept = kept_quads_plain(tri_table[tri], px, py, pair_cell,
                            cov_min).sum(1)
    return torch.where(kept > WIDE, 64, 4 * kept).sum()


def raster_shade_micro_culled_plain(tri_table, pair_tri, seg_start,
                                    seg_count, params, lights, *,
                                    height_padded: int, width_padded: int,
                                    mode: str = "base", span: int = SPAN,
                                    stats: dict | None = None):
    """The kernel's walk of ``raster_shade_micro_plain``, in torch (tests
    only): each pair is culled to the quads of its cell it may cover
    (``kept_quads_plain``); a pair keeping more than ``WIDE`` walks all 16
    quads, as the kernel walks it warp-wide. Each (cell piece, quad) unit
    — pieces cut at the multiples of ``span`` of the pair list in a cell
    of more than ``span`` pairs, as ``raster_shade_micro_spans_plain`` —
    reduces the items that reach it to the (key, pair) minimum of its four
    samples, and the units of a cell merge per pixel by an "amin" of the
    int64 words ((key - 2^31) << 32) + pair. Then the twin's epilogue.
    Equal to ``raster_shade_micro_plain`` bitwise: a culled quad holds no
    sample the pair covers. With ``stats`` (a dict), the counts of pairs,
    kept (pair, quad) items, pairs walked whole and samples tested are
    written into it."""
    device = tri_table.device
    i64 = torch.int64
    none = torch.iinfo(i64).max
    cells, pair_cell, tri, pos = raster._tile_pairs(pair_tri, seg_start,
                                                    seg_count, "flat")
    px, py = raster._tile_samples(params, cells, width_padded // 8, 8, 8)
    cov_min = torch.maximum(params[0], params[1])
    kept = kept_quads_plain(tri_table[tri], px, py, pair_cell, cov_min)
    wide = kept.sum(1) > WIDE
    walked = kept | wide[:, None]
    pair, quad = torch.nonzero(walked, as_tuple=True)  # pair-major
    long_cell = seg_count[cells].long()[pair_cell] > span
    piece = torch.where(long_cell, torch.div(pos, span, rounding_mode="floor")
                        + 1, 0)
    units, unit = torch.unique(pair_cell * (pair_tri.shape[0] + 1) + piece,
                               return_inverse=True)
    unit_cell = torch.div(units, pair_tri.shape[0] + 1, rounding_mode="floor")
    pix = _quad_pixels(device)  # (16, 4)
    # Units of four samples: (piece, quad), entries in pair order.
    upx = px[unit_cell][:, pix].reshape(-1, 4)
    upy = py[unit_cell][:, pix].reshape(-1, 4)
    best, first = raster._walk_plain(tri_table, unit[pair] * 16 + quad,
                                     tri[pair], pos[pair], upx, upy, cov_min)
    word = torch.where(best != common.DEPTH_CLEAR,
                       ((best - 2**31) << 32) + first, none)
    dest = (unit_cell[:, None] * 64 + pix.reshape(1, -1)).reshape(-1)
    merged = torch.full((cells.shape[0] * 64,), none, dtype=i64,
                        device=device).scatter_reduce(
        0, dest, word.reshape(-1), "amin").reshape(-1, 64)
    hit = merged != none
    best = torch.where(hit, (merged >> 32) + 2**31, common.DEPTH_CLEAR)
    winner = torch.where(hit, merged & 0xFFFFFFFF, 0)
    if stats is not None:
        stats.update(pairs=int(tri.shape[0]), items=int(kept.sum()), wide=int(wide.sum()),
                     samples=4 * int(pair.shape[0]))
    return raster._frame_outputs(
        tri_table, cells, best, pair_tri.long()[winner], winner, px, py,
        params, lights, height_padded=height_padded,
        width_padded=width_padded, tile_h=8, tile_w=8, mode=mode,
        no_id=raster.PAIR_IDX_CLEAR)


def ids_scratch(device, height_padded, width_padded):
    """The kernel's plane of each pixel's winning pair, which its walk
    writes and its shading epilogue reads (int32, (Hp, Wp)), per (device,
    Hp, Wp): made once, eagerly, as ``common.merge_scratch``; the walk
    writes every pixel the epilogue reads, so it is never cleared."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    k = (index, height_padded, width_padded)
    if k not in _IDS_SCRATCH:
        _IDS_SCRATCH[k] = torch.empty((height_padded * width_padded,),
                                      dtype=I32, device=device)
    return _IDS_SCRATCH[k]


def _micro_cuda(tri_table, pair_tri, seg_start, seg_count, tile_count,
                params, lights, *, height_padded, width_padded, mode="base",
                worklist=None, acc=None):
    from compute_renderer_torch import _build

    device = tri_table.device
    ntx = width_padded // 128
    num_tiles = ntx * (height_padded // 8)
    if seg_count.shape[0] != num_tiles * 16:
        raise ValueError(f"seg_count has {seg_count.shape[0]} cells, the "
                         f"{height_padded}x{width_padded} frame "
                         f"{num_tiles * 16}")
    table, row_stride = raster.kernel_table(tri_table)  # float4 rows
    pairs = pair_tri.to(I32).contiguous()
    starts = seg_start.to(I32).contiguous()
    counts = seg_count.to(I32).contiguous()
    if worklist is None:
        worklist = binning.occupied_worklist(tile_count.to(I32))
    wl, k = worklist
    wl = wl.to(I32).contiguous()
    k = k.to(I32).reshape(1).contiguous()
    out, key = raster.cleared_outputs(mode, lights.shape[0], height_padded,
                                      width_padded, device,
                                      no_id=raster.PAIR_IDX_CLEAR)
    words, arrivals = common.merge_scratch(device, height_padded,
                                           width_padded)
    ids = ids_scratch(device, height_padded, width_padded)
    fn = _build.entry("micro", "raster_shade_micro", pointers=14, ints=7)
    tracing.launch("raster_shade_micro", mode)
    _build.check(
        fn(table.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
           counts.data_ptr(), wl.data_ptr(), k.data_ptr(), params.data_ptr(),
           lights.data_ptr(), out.data_ptr(), key.data_ptr(),
           words.data_ptr(), arrivals.data_ptr(), ids.data_ptr(),
           binning.acc_pointer(acc, device), raster.MODES[mode],
           row_stride, num_tiles, lights.shape[0], ntx, width_padded,
           pairs.shape[0], torch.cuda.current_stream(device).cuda_stream),
        "raster_shade_micro",
    )
    return out, key


def raster_shade_micro(tri_table, pair_tri, seg_start, seg_count, tile_count,
                       effect, view_position, light_world_pos, light_color,
                       light_intensity, *, height_padded: int,
                       width_padded: int, mode: str = "base",
                       y_offset: int = 0, worklist=None, acc=None):
    """Raster + shade the padded (Hp, Wp) framebuffer, Hp a multiple of 8
    and Wp of 128, in ``mode`` (as ``raster.raster_shade_tiles``) from the
    (T, R) table, the cell-sorted ``pair_tri``, per-cell ``seg_start`` /
    ``seg_count`` and per-tile ``tile_count``, its first row at global
    row ``y_offset`` (a stripe of a sharded render). Returns (out, best_key
    (Hp, Wp) u32) with ``out`` as the tile raster's, except that vis
    writes the winner's index in ``pair_tri`` (``raster.PAIR_IDX_CLEAR``
    where none covers). A G-buffer's planes are defined where the key is
    set and undefined elsewhere (the twin holds zeros there).

    CPU tensors take the twin, CUDA tensors the kernel
    (``launches.raster_shade_micro`` of ``tracing.counters()`` counts its
    launches, ``launches.raster_shade_micro.<mode>`` per mode; a CUDA
    graph's capture ticks them, its replays do not), launched over the
    occupied-tile work list:
    ``worklist`` = (ids, k) as ``binning.bin_cells_sort_meta`` gives them
    (``occupied_worklist`` of ``tile_count``), built here when None. The
    twin walks the occupied tiles itself. ``acc`` ((7,) int64, or None:
    ``binning``'s accumulator) gains the coverage samples the kernel
    tested in ``acc[4]``; the twin adds ``samples_tested_plain``."""
    raster.check_mode(tri_table, mode)
    params, lights = raster.shading_inputs(effect, view_position,
                                           light_world_pos, light_color,
                                           light_intensity, y_offset)
    kw = dict(height_padded=height_padded, width_padded=width_padded,
              mode=mode)
    device = tri_table.device
    if device.type == "cpu":
        out, key = raster_shade_micro_plain(
            tri_table, pair_tri, seg_start, seg_count, params, lights, **kw)
        if acc is not None:
            acc[4:5].add_(samples_tested_plain(
                tri_table, pair_tri, seg_start, seg_count, params,
                width_padded=width_padded))
    elif device.type == "cuda":
        out, key = _micro_cuda(tri_table, pair_tri, seg_start, seg_count,
                               tile_count, params, lights, worklist=worklist,
                               acc=acc, **kw)
    else:
        raise ValueError(f"raster_shade_micro: no kernel for device {device}")
    return raster.public_outputs(mode, out, key)

