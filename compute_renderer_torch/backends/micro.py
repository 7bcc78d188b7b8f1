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
y in [8 ti, +8) plus the row offset.

The coefficient rows are read from the (T, R) table at ``pair_tri[p]``:
the JAX package's P-sized pair stream (``build_pair_coeffs``) and its
complex64 packing are TPU mechanics the port does not carry.

A CUDA tensor runs the hand-written kernel ``csrc/micro.cu``; a CPU tensor
runs ``raster_shade_micro_plain``.
"""

from __future__ import annotations

import torch

from compute_renderer_torch.backends import raster

I32 = torch.int32


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


def _micro_cuda(tri_table, pair_tri, seg_start, seg_count, tile_count,
                params, lights, *, height_padded, width_padded, mode="base"):
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
    wl, k = raster.occupied_worklist(tile_count.to(I32))
    k = k.reshape(1).contiguous()
    out, key = raster.cleared_outputs(mode, lights.shape[0], height_padded,
                                      width_padded, device,
                                      no_id=raster.PAIR_IDX_CLEAR)
    fn = _build.entry("micro", "raster_shade_micro", pointers=10, ints=6)
    raster_shade_micro.launches += 1
    raster_shade_micro.mode_launches[mode] += 1
    _build.check(
        fn(table.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
           counts.data_ptr(), wl.data_ptr(), k.data_ptr(), params.data_ptr(),
           lights.data_ptr(), out.data_ptr(), key.data_ptr(),
           raster.MODES[mode], row_stride, num_tiles, lights.shape[0], ntx,
           width_padded, torch.cuda.current_stream(device).cuda_stream),
        "raster_shade_micro",
    )
    return out, key


def raster_shade_micro(tri_table, pair_tri, seg_start, seg_count, tile_count,
                       effect, view_position, light_world_pos, light_color,
                       light_intensity, *, height_padded: int,
                       width_padded: int, mode: str = "base"):
    """Raster + shade the padded (Hp, Wp) framebuffer, Hp a multiple of 8
    and Wp of 128, in ``mode`` (as ``raster.raster_shade_tiles``) from the
    (T, R) table, the cell-sorted ``pair_tri``, per-cell ``seg_start`` /
    ``seg_count`` and per-tile ``tile_count``. Returns (out, best_key
    (Hp, Wp) u32) with ``out`` as the tile raster's, except that vis
    writes the winner's index in ``pair_tri`` (``raster.PAIR_IDX_CLEAR``
    where none covers).

    CPU tensors take the twin, CUDA tensors the kernel
    (``raster_shade_micro.launches`` counts its launches,
    ``mode_launches`` per mode), launched over the occupied-tile work
    list of ``tile_count``."""
    raster.check_mode(tri_table, mode)
    params, lights = raster.shading_inputs(effect, view_position,
                                           light_world_pos, light_color,
                                           light_intensity)
    kw = dict(height_padded=height_padded, width_padded=width_padded,
              mode=mode)
    device = tri_table.device
    if device.type == "cpu":
        out, key = raster_shade_micro_plain(
            tri_table, pair_tri, seg_start, seg_count, params, lights, **kw)
    elif device.type == "cuda":
        out, key = _micro_cuda(tri_table, pair_tri, seg_start, seg_count,
                               tile_count, params, lights, **kw)
    else:
        raise ValueError(f"raster_shade_micro: no kernel for device {device}")
    return raster.public_outputs(mode, out, key)


raster_shade_micro.launches = 0
raster_shade_micro.mode_launches = dict.fromkeys(raster.MODES, 0)
