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
in torch, for the tests.
"""

from __future__ import annotations

import torch

from compute_renderer_torch import tracing

from compute_renderer_torch.backends import binning, common, raster

I32 = torch.int32
# The longest range of pairs a warp of the kernel walks (csrc/micro.cu).
SPAN = 128
# The span merge's words and counters, per (device, Hp, Wp): each launch
# leaves them clear for the next.
_MERGE_SCRATCH: dict = {}


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


def merge_scratch(device, height_padded, width_padded):
    """The kernel's span-merge state for a frame size on a device: one
    int64 word a pixel, all ones, and one int32 counter a cell, zero —
    made once and left clear by every launch. Made eagerly: the renderer
    runs an eager frame before it captures one in a CUDA graph, so that a
    graph reads these buffers and never makes them (a buffer made inside
    a capture would come from the graph's pool, filled only at replay)."""
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    k = (index, height_padded, width_padded)
    if k not in _MERGE_SCRATCH:
        cells = height_padded * width_padded // 64
        _MERGE_SCRATCH[k] = (
            torch.full((cells * 64,), -1, dtype=torch.int64, device=device),
            torch.zeros((cells,), dtype=I32, device=device))
    return _MERGE_SCRATCH[k]


def _micro_cuda(tri_table, pair_tri, seg_start, seg_count, tile_count,
                params, lights, *, height_padded, width_padded, mode="base",
                worklist=None):
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
    words, arrivals = merge_scratch(device, height_padded, width_padded)
    fn = _build.entry("micro", "raster_shade_micro", pointers=12, ints=7)
    tracing.launch("raster_shade_micro", mode)
    _build.check(
        fn(table.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
           counts.data_ptr(), wl.data_ptr(), k.data_ptr(), params.data_ptr(),
           lights.data_ptr(), out.data_ptr(), key.data_ptr(),
           words.data_ptr(), arrivals.data_ptr(), raster.MODES[mode],
           row_stride, num_tiles, lights.shape[0], ntx, width_padded,
           pairs.shape[0], torch.cuda.current_stream(device).cuda_stream),
        "raster_shade_micro",
    )
    return out, key


def raster_shade_micro(tri_table, pair_tri, seg_start, seg_count, tile_count,
                       effect, view_position, light_world_pos, light_color,
                       light_intensity, *, height_padded: int,
                       width_padded: int, mode: str = "base",
                       y_offset: int = 0, worklist=None):
    """Raster + shade the padded (Hp, Wp) framebuffer, Hp a multiple of 8
    and Wp of 128, in ``mode`` (as ``raster.raster_shade_tiles``) from the
    (T, R) table, the cell-sorted ``pair_tri``, per-cell ``seg_start`` /
    ``seg_count`` and per-tile ``tile_count``, its first row at global
    row ``y_offset`` (a stripe of a sharded render). Returns (out, best_key
    (Hp, Wp) u32) with ``out`` as the tile raster's, except that vis
    writes the winner's index in ``pair_tri`` (``raster.PAIR_IDX_CLEAR``
    where none covers).

    CPU tensors take the twin, CUDA tensors the kernel
    (``launches.raster_shade_micro`` of ``tracing.counters()`` counts its
    launches, ``launches.raster_shade_micro.<mode>`` per mode; a CUDA
    graph's capture ticks them, its replays do not), launched over the
    occupied-tile work list:
    ``worklist`` = (ids, k) as ``binning.bin_cells_sort_meta`` gives them
    (``occupied_worklist`` of ``tile_count``), built here when None. The
    twin walks the occupied tiles itself."""
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
    elif device.type == "cuda":
        out, key = _micro_cuda(tri_table, pair_tri, seg_start, seg_count,
                               tile_count, params, lights, worklist=worklist,
                               **kw)
    else:
        raise ValueError(f"raster_shade_micro: no kernel for device {device}")
    return raster.public_outputs(mode, out, key)

