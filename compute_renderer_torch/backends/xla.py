"""Brute-force comparator backend, in torch.

Counterpart of the JAX package's ``backends/xla.py``: the simple,
known-good baseline (the role the reference's wgpu pipeline plays,
src/wgpu_pipeline/) with the full custom-pipeline semantics — effects,
bitcast-u32 depth ordering, tile-rectangle raster regions — so it is
pixel-comparable with the engine (``backends/cuda.py``) and the JAX
package. Plain torch ops, run eagerly on the frame's device; no kernel is
written for it.

Algorithm: every live triangle is tested against every pixel of its
covered pixel rectangle (``common.triangle_setup``'s ``px_*``, outside
which the JAX mask is already false), carrying per pixel the
lexicographic minimum of (u32 depth key, triangle id) in one int64
(``pack_key``): the lowest key wins, and on equal keys the lowest
triangle id, which is the JAX scan's strict ``<`` over chunks in
triangle order. Attributes are resolved once at the end for the winner
(``common.resolve_attributes``), kd and the atlas sampled, and
``common.shade`` shades.

The work is grouped for the card (``window_groups``): the live
triangles, in id order, are cut into granules of ``chunk``; each granule
has the union of its triangles' rectangles as its pixel window, read to
the host once a frame, and consecutive granules merge into one step
while the merged (triangles x window pixels) stays within twice their
separate sizes or ``MERGE_ELEMENTS``, and within ``STEP_ELEMENTS`` (the
bound on a step's intermediates). A step computes only inside its
window. Because the minimum is taken over (key, id), the frame is the
same bit for bit at every ``chunk`` and grouping.
"""

from __future__ import annotations

import numpy as np
import torch

from compute_renderer_torch.backends import common
from compute_renderer_torch.backends.common import F32, NO_TRI

# A step's (triangles x window pixels) bounds: below MERGE_ELEMENTS two
# granules always merge (a step's launches cost more than its elements);
# no step exceeds STEP_ELEMENTS (8 B per element: 256 MiB per int64
# intermediate).
MERGE_ELEMENTS = 1 << 21
STEP_ELEMENTS = 1 << 25
# Triangles per granule of the windows.
DEFAULT_CHUNK = 64

# pack_key's cleared value: above every packed (key, id) of a covered
# sample (a covered key is never 0xFFFFFFFF: NaN depths are masked).
PACKED_CLEAR = torch.iinfo(torch.int64).max
_ID_SCALE = 1 << 32


def pack_key(key_u32, ids):
    """(u32 key held in int64, non-negative id < 2^31) -> one int64 whose
    signed order is the lexicographic order of (key, id): the key less
    2^31 in the high word, the id in the low one."""
    return (key_u32 - (1 << 31)) * _ID_SCALE + ids


def unpack_key(packed):
    """Inverse of ``pack_key``: (the key's bits as int32, the id as
    int64)."""
    high = torch.div(packed, _ID_SCALE, rounding_mode="floor")
    return (high.to(torch.int32) ^ torch.iinfo(torch.int32).min,
            packed - high * _ID_SCALE)


def window_groups(windows: np.ndarray, chunk: int, count: int) -> list:
    """Steps over ``count`` live triangles cut into granules of ``chunk``:
    ``windows`` (G, 4) int [x0, x1, y0, y1) per granule (empty where x1 <=
    x0 or y1 <= y0). Returns [(s, e, x0, x1, y0, y1)]: triangles [s, e)
    of the live list over the union window, the granules merged as the
    module docstring says; empty granules are skipped."""
    groups = []
    cur = None  # [s, e, x0, x1, y0, y1, separate cost]
    for g, (x0, x1, y0, y1) in enumerate(windows.tolist()):
        s = g * chunk
        e = min(s + chunk, count)
        if x1 <= x0 or y1 <= y0:
            if cur is not None:
                groups.append(tuple(cur[:6]))
                cur = None
            continue
        own = (e - s) * (x1 - x0) * (y1 - y0)
        if cur is not None:
            ux0, ux1 = min(cur[2], x0), max(cur[3], x1)
            uy0, uy1 = min(cur[4], y0), max(cur[5], y1)
            merged = (e - cur[0]) * (ux1 - ux0) * (uy1 - uy0)
            if merged <= STEP_ELEMENTS and (
                    merged <= MERGE_ELEMENTS or merged <= 2 * (cur[6] + own)):
                cur = [cur[0], e, ux0, ux1, uy0, uy1, cur[6] + own]
                continue
            groups.append(tuple(cur[:6]))
        cur = [s, e, x0, x1, y0, y1, own]
    if cur is not None:
        groups.append(tuple(cur[:6]))
    return groups


def granule_windows(x0, x1, y0, y1, chunk: int, width: int, height: int):
    """(G, 4) int64 numpy [x0, x1, y0, y1) per granule of ``chunk`` live
    triangles: the union of their (L,) int pixel rectangles (an empty
    rectangle adds nothing). One read to the host."""
    L = x0.shape[0]
    G = (L + chunk - 1) // chunk
    pad = G * chunk - L
    empty = (x1 <= x0) | (y1 <= y0)
    x0 = torch.where(empty, width, x0)
    x1 = torch.where(empty, 0, x1)
    y0 = torch.where(empty, height, y0)
    y1 = torch.where(empty, 0, y1)

    def rows(a, fill):
        a = a.to(torch.int64)
        if pad:
            a = torch.cat([a, torch.full((pad,), fill, dtype=torch.int64,
                                         device=a.device)])
        return a.reshape(G, chunk)

    win = torch.stack([rows(x0, width).amin(1), rows(x1, 0).amax(1),
                       rows(y0, height).amin(1), rows(y1, 0).amax(1)], 1)
    return win.cpu().numpy()


def render_frame(
    positions,
    normals,
    uvs,
    tri,  # (T, 3) int32
    view_proj,
    view_position,
    light_world_pos,
    light_color,
    light_intensity,
    effect,
    *,
    width: int,
    height: int,
    tile_h: int = 8,
    tile_w: int = 8,
    chunk: int = DEFAULT_CHUNK,
    face_kd=None,  # (T, 3) f32 per-triangle diffuse (material extension)
    face_tex=None,  # (T,) i32 texture slot (texture extension)
    texels=None,  # (P, 3) f32 flat atlas pool (mip-extended for the mips)
    tex_table=None,  # (M, 3) i32 {offset, width, height}
    tex_filter: str = "nearest",  # or bilinear, trilinear, anisotropic
    tex_mips=None,  # (M, L, 3) i32 mip level table (mip filters only)
    return_tri: bool = False,
):
    """Render one frame; returns ((H, W, 4) u8 RGBA, depth key (H, W)
    u32), and with ``return_tri`` the winner ids (H, W) i32 (``NO_TRI``
    where uncovered).

    ``face_kd`` (optional) enables the material extension: the winner's
    diffuse modulates ambient and diffuse in ``common.shade``.
    ``face_tex``/``texels``/``tex_table`` (together; ``tex_mips`` under a
    mip filter, with ``texels`` the mip pool) enable the texture
    extension: the diffuse is further modulated by the atlas sample at
    the interpolated uv (``common.textured_shade``)."""
    device = positions.device
    if tri.shape[0] == 0:
        rgba0, key0 = common.empty_frame(width, height, device)
        if return_tri:
            return rgba0, key0, torch.full((height, width), NO_TRI,
                                           dtype=torch.int32, device=device)
        return rgba0, key0
    tri = tri.to(torch.int32)
    world, screen = common.vertex_stage(positions, view_proj, effect,
                                        width, height)
    setup = common.triangle_setup(screen, tri, effect, width, height,
                                  tile_h, tile_w)
    px, py = common.pixel_grid(effect, width, height)
    threshold, melt_threshold = common.coverage_thresholds(effect)

    # The live triangles in id order, and their coefficient rows in the
    # rasters' anchored affine form (the same floats as the engine's
    # coefficient table).
    ids = torch.nonzero(setup["alive"]).flatten()
    v = screen[tri.long()[ids]]  # (L, 3, 4)
    co = common.barycentric_coefficients(v[:, 0, 0], v[:, 0, 1], v[:, 1, 0],
                                         v[:, 1, 1], v[:, 2, 0], v[:, 2, 1])
    za, zb, zc = common.affine_combine(co, v[:, 0, 2], v[:, 1, 2],
                                       v[:, 2, 2])
    cols = [co["a1"], co["b1"], co["c1"], co["a2"], co["b2"], co["c2"],
            co["a3"], co["b3"], co["c3"], za, zb, zc, co["ax"], co["ay"]]
    rect = [setup[k][ids] for k in ("px_x0", "px_x1", "px_y0", "px_y1")]

    best = torch.full((height, width), PACKED_CLEAR, dtype=torch.int64,
                      device=device)
    windows = granule_windows(*rect, chunk, width, height)
    for s, e, x0, x1, y0, y1 in window_groups(windows, chunk,
                                              int(ids.shape[0])):
        c = [a[s:e, None, None] for a in cols]
        dx = px[y0:y1, x0:x1] - c[12]
        dy = py[y0:y1, x0:x1] - c[13]
        bc1 = c[0] + c[1] * dx + c[2] * dy
        bc2 = c[3] + c[4] * dx + c[5] * dy
        bc3 = c[6] + c[7] * dx + c[8] * dy
        mask = (bc1 >= threshold) & (bc2 >= threshold) & (bc3 >= threshold)
        min_bc = torch.minimum(bc1, torch.minimum(bc2, bc3))
        mask &= min_bc >= melt_threshold
        z = c[9] + c[10] * dx + c[11] * dy
        mask &= torch.isfinite(z)
        xi = torch.arange(x0, x1, device=device)
        yi = torch.arange(y0, y1, device=device)
        r = [a[s:e, None, None] for a in rect]
        mask &= (xi >= r[0]) & (xi < r[1])
        mask &= (yi[:, None] >= r[2]) & (yi[:, None] < r[3])
        packed = pack_key(common.depth_key(z), ids[s:e, None, None])
        packed = torch.where(mask, packed, PACKED_CLEAR).amin(0)
        view = best[y0:y1, x0:x1]
        view.copy_(torch.minimum(view, packed))

    flag = best != PACKED_CLEAR
    key, winner = unpack_key(best)
    best_tri = torch.where(flag, winner, NO_TRI).to(torch.int32)
    best_key = torch.where(flag, key, -1).view(torch.uint32)

    gbuffer = common.resolve_attributes(best_tri, tri, screen, world,
                                        normals.to(F32), uvs.to(F32), effect,
                                        width, height)
    lwp, lc, li = (light_world_pos.to(F32), light_color.to(F32),
                   light_intensity.to(F32))
    vpos = view_position.to(F32)
    if face_tex is not None:
        mip = tex_filter in common.MIP_FILTERS
        guv = common.uv_gradients(tri, screen, uvs.to(F32)) if mip else None
        rgba = common.textured_shade(
            gbuffer, best_tri, face_kd, face_tex, texels, tex_table, vpos,
            lwp, lc, li, tex_filter=tex_filter, tex_mips=tex_mips, guv=guv)
    else:
        if face_kd is not None:
            kd = face_kd.to(F32)[torch.where(flag, best_tri, 0).long()]
            kd = torch.where(flag[..., None], kd, 1.0)
        else:
            kd = torch.ones(flag.shape + (3,), dtype=F32, device=device)
        rgba = common.shade(dict(gbuffer, kd=kd), vpos, lwp, lc, li)
    if return_tri:
        return rgba, best_key, best_tri
    return rgba, best_key


def mesh_ext_tensors(mesh, tri, device, tex_filter: str = "nearest"):
    """The mesh's material and texture inputs of ``render_frame`` on
    ``device``: ``face_kd``, and for a textured mesh ``face_tex``,
    ``texels`` (the mip pool under a mip filter, with ``tex_mips``),
    ``tex_table`` and ``tex_filter`` — the deferred tail's inputs, which
    ``cuda.mesh_ext_tensors`` builds."""
    from compute_renderer_torch.backends import cuda

    ext = cuda.mesh_ext_tensors(mesh, tri, device, tex_filter=tex_filter,
                                tex_mode="deferred")
    ext.pop("tex_mode", None)
    ext.pop("uvs", None)  # render_frame takes the uvs as an argument
    return ext


def render(mesh, camera_uniform, lights, effect, width, height, *,
           device="cuda", tile_h: int = 8, tile_w: int = 8,
           chunk: int = DEFAULT_CHUNK, tex_filter: str = "nearest"):
    """Host-level entry: numpy / dataclasses in, (H, W, 4) u8 numpy out,
    rendered on ``device`` ("cuda", the default, raises without a card;
    "cpu" runs here)."""
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("xla.render(device='cuda') needs an NVIDIA GPU "
                           "with CUDA; pass device='cpu'")
    def dev(a, dtype=F32):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    light_world_pos, light_color, light_intensity = lights
    tri = dev(mesh.indices.astype(np.int32), torch.int32).reshape(-1, 3)
    ext = mesh_ext_tensors(mesh, tri, device, tex_filter)
    rgba, _ = render_frame(
        dev(mesh.positions), dev(mesh.normals), dev(mesh.uvs), tri,
        dev(camera_uniform.view_proj), dev(camera_uniform.view_position),
        dev(light_world_pos), dev(light_color), dev(light_intensity),
        dev(effect), width=width, height=height, tile_h=tile_h,
        tile_w=tile_w, chunk=chunk, **ext)
    return rgba.cpu().numpy()
