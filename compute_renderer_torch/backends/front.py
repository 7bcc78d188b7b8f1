"""Fused front end: vertex stage + triangle setup + coefficient rows.

Counterpart of the JAX package's ``backends/pallas_front.py``, at tile or
8x8-cell granularity. ``front_end`` takes corner-SoA geometry
(``pos_soa``/``nrm_soa`` (3 corners, 3 components, T)) and returns

- ``table`` (T, R) f32: the rasters' coefficient table, columns in
  ``raster.py`` order, R = 32 in base mode, 35 with ``kd_rows`` (the
  material columns), 44 with ``uv_soa`` + ``tex_rows`` (the fused-texture
  columns; kd is ``kd_rows`` or ones) and 46 with ``uv_soa`` +
  ``mip_rows`` (the mip-filtered texture columns: the frame's (T, 5)
  ``common.mip_tri_rows`` in place of the TextureInfo rows). It is a view
  in the layout both raster kernels read (``raster.empty_table``: row
  stride R rounded up to a multiple of 4 floats, 16-byte aligned), so
  ``raster.kernel_table`` passes it on without a copy. The pad column is
  no column of the table: the kernel writes 0 there, the twin nothing.
  (The JAX package's front writes (R, T), triangles on lanes: the TPU's
  layout.)
- ``meta`` (4, T) i32: tile_x0, tile_y0, rect width rx, cover count c
  (0 for culled triangles) — what ``binning.setup_from_meta`` reads.

A CUDA tensor runs the hand-written kernel ``csrc/front.cu``; a CPU tensor
runs ``front_end_plain``, the same arithmetic in eager torch. The kernel
and the twin compute the same IEEE values (see the kernel's header).
"""

from __future__ import annotations

import torch

from compute_renderer_torch import tracing

from compute_renderer_torch.backends import binning, common, raster

F32 = torch.float32


# The front's modes (the vis mode's table is the base one).
MODES = ("base", "mat", "texf", "texf_mip")


def front_end_plain(pos_soa, nrm_soa, view_proj, effect, *, width: int,
                    height: int, tile_h: int, tile_w: int, kd_rows=None,
                    uv_soa=None, tex_rows=None, mip_rows=None):
    """The twin: ``common.vertex_stage`` -> ``common.triangle_setup`` ->
    ``raster.tri_table_columns`` on the corner vertices, reduced to the
    kernel's (table, meta) in the kernel's layout."""
    mode = _mode(kd_rows, uv_soa, tex_rows, mip_rows)
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
    cols = raster.tri_table_columns(
        screen_soa, nrm_soa.to(F32), world_soa, face_kd=kd_rows,
        uv_soa=uv_soa, tex_rows=mip_rows if mode == "texf_mip" else tex_rows)
    table = raster.empty_table(T, len(cols), device)
    table.copy_(torch.stack(cols, dim=1))
    return table, meta.to(torch.int32)


def _mode(kd_rows, uv_soa, tex_rows, mip_rows) -> str:
    if tex_rows is not None or mip_rows is not None:
        if uv_soa is None:
            raise ValueError("the texture front end needs uv_soa")
        if tex_rows is not None and mip_rows is not None:
            raise ValueError("tex_rows (texf) and mip_rows (texf_mip) are "
                             "two modes")
        return "texf" if mip_rows is None else "texf_mip"
    return "mat" if kd_rows is not None else "base"


def _front_end_cuda(pos_soa, nrm_soa, view_proj, effect, *, width, height,
                    tile_h, tile_w, kd_rows=None, uv_soa=None,
                    tex_rows=None, mip_rows=None):
    from compute_renderer_torch import _build

    T = pos_soa.shape[2]
    device = pos_soa.device
    mode = _mode(kd_rows, uv_soa, tex_rows, mip_rows)
    pos = pos_soa.to(F32).contiguous()
    nrm = nrm_soa.to(F32).contiguous()
    if nrm.shape != pos.shape:
        raise ValueError(f"nrm_soa {tuple(nrm.shape)} != pos_soa "
                         f"{tuple(pos.shape)}")

    def rows(a, shape, what):
        if a is None:
            return None
        a = a.to(device=device, dtype=F32).contiguous()
        if tuple(a.shape) != shape:
            raise ValueError(f"{what} {tuple(a.shape)}, expected {shape}")
        return a

    kd = rows(kd_rows, (T, 3), "kd_rows")
    uv = rows(uv_soa, (3, 2, T), "uv_soa") if mode.startswith("texf") \
        else None
    # The per-triangle block the texture modes copy: TextureInfo or mips.
    tex = (rows(tex_rows, (T, 3), "tex_rows") if mode == "texf" else
           rows(mip_rows, (T, 5), "mip_rows") if mode == "texf_mip" else
           None)
    scal = torch.cat([view_proj.to(device=device, dtype=F32).reshape(16),
                      effect.to(device=device, dtype=F32).reshape(-1)[:6]])
    table = raster.empty_table(T, raster.MODE_WIDTHS[mode], device)
    meta = torch.empty((4, T), dtype=torch.int32, device=device)
    ptr = lambda a: None if a is None else a.data_ptr()
    fn = _build.entry("front", "front_end", pointers=8, ints=6)
    tracing.launch("front_end", mode)
    _build.check(
        fn(pos.data_ptr(), nrm.data_ptr(), scal.data_ptr(), ptr(kd), ptr(uv),
           ptr(tex), table.data_ptr(), meta.data_ptr(),
           raster.MODES[mode], T, width, height, tile_h, tile_w,
           torch.cuda.current_stream(device).cuda_stream),
        "front_end",
    )
    return table, meta


def front_end(pos_soa, nrm_soa, view_proj, effect, *, width: int,
              height: int, tile_h: int, tile_w: int, kd_rows=None,
              uv_soa=None, tex_rows=None, mip_rows=None):
    """Fused vertex + setup + coefficient rows; returns (table (T, R) f32
    in the rasters' layout, meta (4, T) i32). ``kd_rows`` (T, 3) selects
    the material rows, ``uv_soa`` (3 corners, 2, T) with ``tex_rows``
    (T, 3) the fused-texture rows, ``uv_soa`` with ``mip_rows`` (T, 5)
    the mip-filtered ones. CPU tensors take the plain twin, CUDA tensors the
    kernel (``launches.front_end`` of ``tracing.counters()`` counts its
    launches, ``launches.front_end.<mode>`` per mode; a CUDA graph's
    capture ticks them, its replays do not)."""
    kw = dict(width=width, height=height, tile_h=tile_h, tile_w=tile_w,
              kd_rows=kd_rows, uv_soa=uv_soa, tex_rows=tex_rows,
              mip_rows=mip_rows)
    _mode(kd_rows, uv_soa, tex_rows, mip_rows)
    if pos_soa.device.type == "cpu":
        return front_end_plain(pos_soa, nrm_soa, view_proj, effect, **kw)
    if pos_soa.device.type != "cuda":
        raise ValueError(f"front_end: no kernel for device {pos_soa.device}")
    return _front_end_cuda(pos_soa, nrm_soa, view_proj, effect, **kw)

