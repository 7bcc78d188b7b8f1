"""Fused front end: vertex stage + triangle setup + coefficient rows.

Counterpart of the JAX package's ``backends/pallas_front.py`` in base
mode at tile granularity. ``front_end`` takes corner-SoA geometry
(``pos_soa``/``nrm_soa`` (3 corners, 3 components, T)) and returns

- ``coeff`` (32, T) f32: the raster table's columns in
  ``raster.TRI_TABLE_WIDTH`` order (rows = coefficients);
- ``meta`` (4, T) i32: tile_x0, tile_y0, rect width rx, cover count c
  (0 for culled triangles) — what ``binning.setup_from_meta`` reads.

A CUDA tensor runs the hand-written kernel ``csrc/front.cu``; a CPU tensor
runs ``front_end_plain``, the same arithmetic in eager torch. The kernel
and the twin compute the same IEEE values (see the kernel's header).
"""

from __future__ import annotations

import torch

from compute_renderer_torch.backends import binning, common, raster

F32 = torch.float32


def front_end_plain(pos_soa, nrm_soa, view_proj, effect, *, width: int,
                    height: int, tile_h: int, tile_w: int):
    """The twin: ``common.vertex_stage`` -> ``common.triangle_setup`` ->
    ``raster.tri_table_columns`` on the corner vertices, reduced to the
    kernel's (coeff, meta)."""
    T = pos_soa.shape[2]
    device = pos_soa.device
    # Corner-major vertex list: vertex k*T + t is corner k of triangle t.
    positions = pos_soa.to(F32).permute(0, 2, 1).reshape(3 * T, 3)
    world, screen = common.vertex_stage(positions, view_proj, effect,
                                        width, height)
    tri = torch.arange(3 * T, device=device).reshape(3, T).T
    setup = common.triangle_setup(screen, tri, effect, width, height,
                                  tile_h, tile_w)
    rx, _, c = binning.cover_counts(setup)
    meta = torch.stack([setup["tile_x0"], setup["tile_y0"], rx, c])

    screen_soa = tuple(
        tuple(screen[k * T:(k + 1) * T, ch] for ch in range(4))
        for k in range(3)
    )
    world_soa = tuple(
        tuple(world[k * T:(k + 1) * T, ch] for ch in range(3))
        for k in range(3)
    )
    cols = raster.tri_table_columns(screen_soa, nrm_soa.to(F32), world_soa)
    return torch.stack(cols), meta.to(torch.int32)


def _front_end_cuda(pos_soa, nrm_soa, view_proj, effect, *, width, height,
                    tile_h, tile_w):
    from compute_renderer_torch import _build

    T = pos_soa.shape[2]
    device = pos_soa.device
    pos = pos_soa.to(F32).contiguous()
    nrm = nrm_soa.to(F32).contiguous()
    if nrm.shape != pos.shape:
        raise ValueError(f"nrm_soa {tuple(nrm.shape)} != pos_soa "
                         f"{tuple(pos.shape)}")
    scal = torch.cat([view_proj.to(device=device, dtype=F32).reshape(16),
                      effect.to(device=device, dtype=F32).reshape(-1)[:6]])
    coeff = torch.empty((raster.TRI_TABLE_WIDTH, T), dtype=F32,
                        device=device)
    meta = torch.empty((4, T), dtype=torch.int32, device=device)
    fn = _build.entry("front", "front_end_base", pointers=5, ints=5)
    front_end.launches += 1
    _build.check(
        fn(pos.data_ptr(), nrm.data_ptr(), scal.data_ptr(),
           coeff.data_ptr(), meta.data_ptr(), T, width, height, tile_h,
           tile_w, torch.cuda.current_stream(device).cuda_stream),
        "front_end",
    )
    return coeff, meta


def front_end(pos_soa, nrm_soa, view_proj, effect, *, width: int,
              height: int, tile_h: int, tile_w: int):
    """Fused vertex + setup + coefficient rows; returns (coeff (32, T) f32,
    meta (4, T) i32). CPU tensors take the plain twin, CUDA tensors the
    kernel (``front_end.launches`` counts its launches)."""
    if pos_soa.device.type == "cpu":
        return front_end_plain(pos_soa, nrm_soa, view_proj, effect,
                               width=width, height=height, tile_h=tile_h,
                               tile_w=tile_w)
    if pos_soa.device.type != "cuda":
        raise ValueError(f"front_end: no kernel for device {pos_soa.device}")
    return _front_end_cuda(pos_soa, nrm_soa, view_proj, effect, width=width,
                           height=height, tile_h=tile_h, tile_w=tile_w)


front_end.launches = 0
