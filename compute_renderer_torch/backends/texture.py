"""The texture stages of a frame: the fused tails, the deferred tail, the
per-frame mip rows and the deferred mode's vertex stage.

The JAX package fuses these with XLA ops inside its compiled step; here
each is one launch of a hand-written kernel of ``csrc/texture.cu`` for a
CUDA tensor, and its plain version — the ``common`` composition the JAX
package runs — for a CPU tensor. Any other device raises. Each wrapper
counts its kernel's launches as ``launches.<wrapper>`` of
``tracing.counters()`` (a CUDA graph's capture ticks it, its replays do
not).

- ``texture_tail``: a texf G-buffer -> RGBA, nearest or bilinear
  (``common.fused_texture_tail``), over the (P, 3) f32 pool or the
  u8-packed one;
- ``texture_tail_mip``: a texf_mip G-buffer -> RGBA, trilinear or
  anisotropic (``common.fused_texture_tail_mip``), adding the pixels it
  shaded from an image to a batch's accumulator
  (``textured_pixels_plain``);
- ``deferred_tail``: the rasters' vis ids -> RGBA, in every filter
  (``common.resolve_attributes`` then ``common.textured_shade``; under a
  mip filter the winner's row of ``mip_rows`` feeds the fused tails'
  sampler, ``common._sample_mip_px``);
- ``mip_rows``: the frame's (T, 5) mip rows from the positions
  (``common.vertex_stage`` -> ``common.uv_gradients`` ->
  ``common.mip_tri_rows``);
- ``vertex_stage``: the per-vertex world and screen the deferred tail
  reads (``common.vertex_stage``).

The kernels and the plain versions compute the same IEEE values (see the
kernels' header). The G-buffer, ids and keys are read through their row
strides, so the frame's window of the rasters' padded output is read in
place. No wrapper reads a value back to the host: each is capturable.
"""

from __future__ import annotations

import torch

from compute_renderer_torch import tracing

from compute_renderer_torch.backends import binning, common

F32 = torch.float32
I32 = torch.int32
# The kernels' filter argument (csrc/texture.cu).
FILTERS = {"nearest": 0, "bilinear": 1, "trilinear": 2, "anisotropic": 3}
FLAT_FILTERS = ("nearest", "bilinear")


def _device_of(a, what: str):
    """CPU (the plain version), CUDA (the kernel), else a ValueError."""
    if a.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: no kernel for device {a.device}")
    return a.device


def _check_filter(tex_filter: str, allowed, what: str) -> None:
    if tex_filter not in allowed:
        raise ValueError(f"{what} samples {' / '.join(allowed)}, not "
                         f"{tex_filter!r}")


def _on(a, device, dtype, what: str):
    """``a`` as the kernel reads it: on ``device``, of ``dtype``,
    contiguous (no copy when it already is)."""
    if a.device != device:
        raise ValueError(f"{what} is on {a.device}, the frame on {device}")
    return a.to(dtype).contiguous()


def _rows(a, device, what: str):
    """A (H, W) plane the kernels read through its row stride (unit column
    stride), as int32 bits."""
    if a.device != device:
        raise ValueError(f"{what} is on {a.device}, the frame on {device}")
    if a.dim() != 2 or a.element_size() != 4:
        raise ValueError(f"{what}: a (H, W) plane of 32-bit words, not "
                         f"{tuple(a.shape)} {a.dtype}")
    return a if a.stride(1) == 1 else a.contiguous()


def _lights(light_color, light_intensity, device, light_pos=None):
    lc = _on(light_color, device, F32, "light_color")
    li = _on(light_intensity, device, F32, "light_intensity")
    L = lc.shape[0]
    if lc.numel() != 3 * L or li.numel() != L:
        raise ValueError(f"light_color {tuple(lc.shape)} and "
                         f"light_intensity {tuple(li.shape)} for {L} lights")
    if light_pos is None:
        return lc, li, L
    lp = _on(light_pos, device, F32, "light_world_pos")
    if lp.numel() != 3 * L:
        raise ValueError(f"light_world_pos {tuple(lp.shape)} for {L} lights")
    return lp, lc, li, L


def _launch(symbol: str, pointers, ints, device):
    from compute_renderer_torch import _build

    fn = _build.entry("texture", symbol, pointers=len(pointers),
                      ints=len(ints))
    ptr = [None if a is None else a.data_ptr() for a in pointers]
    _build.check(fn(*ptr, *ints,
                    torch.cuda.current_stream(device).cuda_stream), symbol)


def _gbuffer(gbuf, key, device, base: int):
    if gbuf.dim() != 3 or gbuf.dtype != F32 or gbuf.stride(2) != 1:
        raise ValueError(f"a G-buffer is (C, H, W) f32 with unit column "
                         f"stride, not {tuple(gbuf.shape)} {gbuf.dtype} at "
                         f"{gbuf.stride()}")
    if gbuf.device != device:
        raise ValueError(f"gbuf on {gbuf.device}")
    key = _rows(key, device, "key")
    if tuple(key.shape) != tuple(gbuf.shape[1:]):
        raise ValueError(f"key {tuple(key.shape)} for a G-buffer of "
                         f"{tuple(gbuf.shape)}")
    if gbuf.shape[0] < base or (gbuf.shape[0] - base) % 2:
        raise ValueError(f"a G-buffer of {gbuf.shape[0]} planes: {base} "
                         "then two a light")
    return key, (gbuf.shape[0] - base) // 2


def _rgba(H: int, W: int, device):
    return torch.empty((H, W, 4), dtype=torch.uint8, device=device)


# ---------------------------------------------------------------------------
# 1. The fused nearest / bilinear tail
# ---------------------------------------------------------------------------

def texture_tail_plain(gbuf, key, texels, light_color, light_intensity,
                       tex_filter: str = "nearest", texels_packed=None):
    """The plain version: ``common.fused_texture_tail``."""
    return common.fused_texture_tail(gbuf, key, texels, light_color,
                                     light_intensity, tex_filter=tex_filter,
                                     texels_packed=texels_packed)


def texture_tail(gbuf, key, texels, light_color, light_intensity,
                 tex_filter: str = "nearest", texels_packed=None):
    """Shade a texf G-buffer ``gbuf`` (C, H, W) f32 (``common``'s layout,
    C = 8 + 2 lights) with its depth key ``key`` (H, W) (DEPTH_CLEAR =
    background; the planes are read only where the key is set, and may
    hold anything elsewhere): nearest or bilinear repeat-wrap samples of
    ``texels`` (P, 3) f32, or of ``texels_packed`` (P,) i32 when given,
    kd modulated, the material epilogue. Returns (H, W, 4) u8 RGBA.
    ``launches.texture_tail`` counts the kernel's launches."""
    _check_filter(tex_filter, FLAT_FILTERS, "texture_tail")
    device = _device_of(gbuf, "texture_tail")
    if device.type == "cpu":
        return texture_tail_plain(gbuf, key, texels, light_color,
                                  light_intensity, tex_filter, texels_packed)
    key, nl = _gbuffer(gbuf, key, device, common.TEXF_BASE_CHANNELS)
    lc, li, L = _lights(light_color, light_intensity, device)
    if nl != L:
        raise ValueError(f"a G-buffer of {nl} lights shaded with {L}")
    if texels_packed is not None:
        pool, packed = None, _on(texels_packed, device, I32, "texels_packed")
    else:
        pool, packed = _on(texels, device, F32, "texels"), None
    H, W = key.shape
    out = _rgba(H, W, device)
    tracing.launch("texture_tail")
    _launch("texture_tail", (gbuf, key, pool, packed, lc, li, out),
            (H, W, gbuf.stride(0), gbuf.stride(1), key.stride(0), L,
             FILTERS[tex_filter]), device)
    return out



# ---------------------------------------------------------------------------
# 2. The fused trilinear / anisotropic tail
# ---------------------------------------------------------------------------

def texture_tail_mip_plain(gbuf, key, texels, mip_table, light_color,
                           light_intensity, tex_filter: str = "trilinear"):
    """The plain version: ``common.fused_texture_tail_mip``."""
    return common.fused_texture_tail_mip(gbuf, key, texels, mip_table,
                                         light_color, light_intensity,
                                         tex_filter=tex_filter)


def textured_pixels_plain(gbuf, key):
    """The pixels of a texf_mip G-buffer that the tail shades from an
    image, as an int64 scalar tensor: covered (``key`` set) and the
    winner's triangle textured (its carried tid, plane 5, at least 0), the
    ``has`` of ``common._sample_mip_px``."""
    flag = key.view(I32) != -1
    return (flag & (gbuf[5].to(I32) >= 0)).sum()


def texture_tail_mip(gbuf, key, texels, mip_table, light_color,
                     light_intensity, tex_filter: str = "trilinear",
                     acc=None):
    """Shade a texf_mip G-buffer (C = 10 + 2 lights; its planes are read
    only where ``key`` is set, and may hold anything elsewhere): the mip
    sampler on the carried tid / lod / mu / mv / spread over the mip pool
    ``texels`` (P, 3) and its level table ``mip_table`` (M, L, 3) i32, kd
    modulated, the material epilogue. Returns (H, W, 4) u8 RGBA. ``acc``
    ((7,) int64, or None: ``binning``'s accumulator) gains the pixels
    shaded from an image in ``acc[5]``: the kernel counts them, the plain
    version adds ``textured_pixels_plain``. ``launches.texture_tail_mip``
    counts the kernel's launches."""
    _check_filter(tex_filter, common.MIP_FILTERS, "texture_tail_mip")
    device = _device_of(gbuf, "texture_tail_mip")
    if device.type == "cpu":
        if acc is not None:
            acc[5:6].add_(textured_pixels_plain(gbuf, key))
        return texture_tail_mip_plain(gbuf, key, texels, mip_table,
                                      light_color, light_intensity,
                                      tex_filter)
    key, nl = _gbuffer(gbuf, key, device, common.TEXF_MIP_BASE_CHANNELS)
    lc, li, L = _lights(light_color, light_intensity, device)
    if nl != L:
        raise ValueError(f"a G-buffer of {nl} lights shaded with {L}")
    mips = _on(mip_table, device, I32, "mip_table")
    if mips.dim() != 3 or mips.shape[2] != 3 or mips.shape[1] < 1:
        raise ValueError(f"mip_table {tuple(mips.shape)}: (M, L, 3)")
    binning.acc_pointer(acc, device)  # its dtype, shape and device
    H, W = key.shape
    out = _rgba(H, W, device)
    tracing.launch("texture_tail_mip")
    _launch("texture_tail_mip",
            (gbuf, key, _on(texels, device, F32, "texels"), mips, lc, li,
             out, acc),
            (H, W, gbuf.stride(0), gbuf.stride(1), key.stride(0), L,
             mips.shape[1], FILTERS[tex_filter]), device)
    return out



# ---------------------------------------------------------------------------
# 3. The deferred tail
# ---------------------------------------------------------------------------

def _winners(ids, key, pair_tri=None):
    """The winner's triangle per pixel, ``common.NO_TRI`` where none: the
    ids themselves (the tile raster's vis), or on the micro path the
    winner's pair index mapped through ``pair_tri`` where the key is
    set (the JAX package's ``tpu.micro_vis_tail``)."""
    if pair_tri is None:
        return ids
    flag = key.view(I32) != -1
    return torch.where(flag, pair_tri[torch.where(flag, ids, 0).long()],
                       common.NO_TRI)


def deferred_tail_plain(ids, key, tri, screen, world, normals, uvs, effect,
                        face_kd, face_tex, texels, tex_table, view_position,
                        light_world_pos, light_color, light_intensity, *,
                        tex_filter: str = "nearest", tex_mips=None,
                        rows=None, pair_tri=None, x_offset: int = 0,
                        y_offset: int = 0):
    """The plain version: ``_winners``, ``common.resolve_attributes``, then
    ``common.textured_shade``; under a mip filter ``textured_shade``'s
    steps with the winner's row of ``rows`` in the mip sampler
    (``common.sample_atlas_mip`` on the rows it would compute)."""
    best_tri = _winners(ids, key, pair_tri)
    height, width = best_tri.shape
    g = common.resolve_attributes(best_tri, tri, screen, world, normals, uvs,
                                  effect, width, height, x_offset, y_offset)
    if tex_filter not in common.MIP_FILTERS:
        return common.textured_shade(
            g, best_tri, face_kd, face_tex, texels, tex_table,
            view_position, light_world_pos, light_color, light_intensity,
            tex_filter=tex_filter)
    flag = g["flag"]
    winner = torch.where(flag, best_tri, 0).long()
    if face_kd is not None:
        kd = torch.where(flag[..., None], face_kd.to(F32)[winner], 1.0)
    else:
        kd = torch.ones(flag.shape + (3,), dtype=F32, device=flag.device)
    r = rows[winner]  # (H, W, 5)
    texel, has = common._sample_mip_px(
        texels, tex_mips, r[..., 0].to(I32), r[..., 1], r[..., 2],
        r[..., 3], r[..., 4], g["uv"][..., 0], g["uv"][..., 1], flag,
        tex_filter)
    g = dict(g, kd=torch.where(has[..., None], kd * texel, kd))
    return common.shade(g, view_position, light_world_pos, light_color,
                        light_intensity)


def deferred_tail(ids, key, tri, screen, world, normals, uvs, effect,
                  face_kd, face_tex, texels, tex_table, view_position,
                  light_world_pos, light_color, light_intensity, *,
                  tex_filter: str = "nearest", tex_mips=None, rows=None,
                  pair_tri=None, x_offset: int = 0, y_offset: int = 0):
    """Shade the rasters' vis output: ``ids`` (H, W) i32 winner ids (the
    triangle, or with ``pair_tri`` the micro raster's pair index) and
    ``key`` (H, W); per vertex ``screen`` (N, 4) and ``world`` (N, 3)
    (``common.vertex_stage``), ``normals`` (N, 3), ``uvs`` (N, 2);
    ``tri`` (T, 3); ``face_kd`` (T, 3) or None; ``face_tex`` (T,);
    ``texels`` the atlas with ``tex_table`` (M, 3) (nearest, bilinear) or
    the mip pool with ``tex_mips`` (M, L, 3) and the frame's ``rows``
    (T, 5) of ``mip_rows`` (trilinear, anisotropic); the offsets place
    the window at its global pixel (a stripe of a sharded render).
    Returns (H, W, 4) u8 RGBA. ``launches.deferred_tail`` counts
    the kernel's launches."""
    _check_filter(tex_filter, tuple(FILTERS), "deferred_tail")
    mip = tex_filter in common.MIP_FILTERS
    if mip and (tex_mips is None or rows is None):
        raise ValueError(f"tex_filter={tex_filter!r} needs the mip pool, "
                         "tex_mips and the frame's mip rows")
    kw = dict(tex_filter=tex_filter, tex_mips=tex_mips, rows=rows,
              pair_tri=pair_tri, x_offset=x_offset, y_offset=y_offset)
    args = (ids, key, tri, screen, world, normals, uvs, effect, face_kd,
            face_tex, texels, tex_table, view_position, light_world_pos,
            light_color, light_intensity)
    device = _device_of(ids, "deferred_tail")
    if device.type == "cpu":
        return deferred_tail_plain(*args, **kw)
    ids = _rows(ids, device, "ids")
    key = _rows(key, device, "key")
    H, W = ids.shape
    T, N = tri.shape[0], screen.shape[0]
    shapes = [(key, (H, W), "key"), (tri, (T, 3), "tri"),
              (face_tex, (T,), "face_tex"), (screen, (N, 4), "screen"),
              (world, (N, 3), "world"), (normals, (N, 3), "normals"),
              (uvs, (N, 2), "uvs")] + [(rows, (T, 5), "rows")] * mip
    for a, shape, what in shapes:
        if tuple(a.shape) != shape:
            raise ValueError(f"deferred_tail: {what} {tuple(a.shape)}, "
                             f"expected {shape}")
    lp, lc, li, L = _lights(light_color, light_intensity, device,
                            light_world_pos)
    f32 = lambda a, what: _on(a, device, F32, what)
    table = _on(tex_mips if mip else tex_table, device, I32,
                "tex_mips" if mip else "tex_table")
    out = _rgba(H, W, device)
    tracing.launch("deferred_tail")
    _launch("deferred_tail", (
        ids, key,
        None if pair_tri is None else _on(pair_tri, device, I32, "pair_tri"),
        _on(tri, device, I32, "tri"), f32(screen, "screen"),
        f32(world, "world"), f32(normals, "normals"), f32(uvs, "uvs"),
        f32(effect, "effect"),
        None if face_kd is None else f32(face_kd, "face_kd"),
        _on(face_tex, device, I32, "face_tex"), f32(texels, "texels"),
        table, f32(rows, "rows") if mip else None,
        f32(view_position, "view_position"), lp, lc, li, out),
        (H, W, ids.stride(0), key.stride(0), L,
         table.shape[1] if mip else 1, int(x_offset), int(y_offset),
         FILTERS[tex_filter]), device)
    return out



# ---------------------------------------------------------------------------
# 4. The frame's mip rows
# ---------------------------------------------------------------------------

def mip_rows_plain(positions, tri, uvs, face_tex, mip_table, view_proj,
                   effect, width: int, height: int,
                   tex_filter: str = "trilinear"):
    """The plain version: ``common.vertex_stage`` ->
    ``common.uv_gradients`` -> ``common.mip_tri_rows``."""
    _, screen = common.vertex_stage(positions, view_proj, effect, width,
                                    height)
    guv = common.uv_gradients(tri, screen, uvs)
    return common.mip_tri_rows(face_tex, mip_table, guv, tex_filter)


def mip_rows(positions, tri, uvs, face_tex, mip_table, view_proj, effect,
             width: int, height: int, tex_filter: str = "trilinear"):
    """The frame's (T, 5) f32 mip rows [tid, lod, mu, mv, spread] of
    ``common.mip_tri_rows``, from ``positions`` (N, 3), ``tri`` (T, 3),
    ``uvs`` (N, 2), ``face_tex`` (T,) (-1 untextured: padding rows of
    (0, 0, 0) triangles included), ``mip_table`` (M, L, 3) i32 and the
    frame's ``view_proj`` and ``effect`` (the wave moves the corners).
    ``launches.mip_rows`` counts the kernel's launches."""
    _check_filter(tex_filter, common.MIP_FILTERS, "mip_rows")
    device = _device_of(positions, "mip_rows")
    if device.type == "cpu":
        return mip_rows_plain(positions, tri, uvs, face_tex, mip_table,
                              view_proj, effect, width, height, tex_filter)
    T = tri.shape[0]
    tri_c = _on(tri, device, I32, "tri")
    face_tex_c = _on(face_tex, device, I32, "face_tex")
    mips = _on(mip_table, device, I32, "mip_table")
    if tri_c.shape != (T, 3) or face_tex_c.shape != (T,) \
            or mips.dim() != 3 or mips.shape[1] < 1:
        raise ValueError(f"tri {tuple(tri.shape)}, face_tex "
                         f"{tuple(face_tex.shape)}, mip_table "
                         f"{tuple(mip_table.shape)}")
    out = torch.empty((T, 5), dtype=F32, device=device)
    tracing.launch("mip_rows")
    _launch("mip_rows", (
        _on(positions, device, F32, "positions"), tri_c,
        _on(uvs, device, F32, "uvs"), face_tex_c, mips,
        _on(view_proj, device, F32, "view_proj"),
        _on(effect, device, F32, "effect"), out),
        (T, mips.shape[1], int(width), int(height), FILTERS[tex_filter]),
        device)
    return out



# ---------------------------------------------------------------------------
# 5. The per-vertex stage of the deferred mode
# ---------------------------------------------------------------------------

def vertex_stage(positions, view_proj, effect, width: int, height: int):
    """``common.vertex_stage`` of ``positions`` (N, 3): (world (N, 3),
    screen (N, 4)) f32, screen = (x_px, y_px_flipped, ndc_z, clip_w),
    under the frame's ``view_proj`` and ``effect`` (the wave moves the
    vertices). CPU tensors take ``common.vertex_stage`` itself.
    ``launches.vertex_stage`` counts the kernel's launches."""
    device = _device_of(positions, "vertex_stage")
    if device.type == "cpu":
        return common.vertex_stage(positions, view_proj, effect, width,
                                   height)
    pos = _on(positions, device, F32, "positions")
    if pos.dim() != 2 or pos.shape[1] != 3:
        raise ValueError(f"positions {tuple(pos.shape)}: (N, 3)")
    N = pos.shape[0]
    world = torch.empty((N, 3), dtype=F32, device=device)
    screen = torch.empty((N, 4), dtype=F32, device=device)
    tracing.launch("vertex_stage")
    _launch("vertex_stage", (pos, _on(view_proj, device, F32, "view_proj"),
                             _on(effect, device, F32, "effect"), world,
                             screen), (N, int(width), int(height)), device)
    return world, screen


# The five launch-counted wrappers, by kernel name.
WRAPPERS = {"texture_tail": texture_tail,
            "texture_tail_mip": texture_tail_mip,
            "deferred_tail": deferred_tail, "mip_rows": mip_rows,
            "vertex_stage": vertex_stage}
