"""The deferred texture mode (vis: the rasters write the winner's id, a
torch tail resolves, samples and shades it) against the JAX package, on
the small structured build of tests/test_torch_ext.py (5,362 triangles)
at 256x192, first person at (13.566635, 4.0, 24.0).

Tolerances, by reference:

- the JAX chain run op by op (``jax.disable_jit()``): bitwise —
  ``resolve_attributes``, ``sample_atlas`` and ``textured_shade`` with
  the nearest and bilinear filters on the same winners; the mip filters
  within 1 LSB of RGBA and 1e-5 of a texel, since their lod is log2 of a
  square root and XLA:CPU's log2 is not torch's (tests/test_torch_mip.py);
- the Pallas kernels in interpret mode (XLA:CPU contracts mul+add into
  FMA inside them, which flips samples exactly on an edge): at most
  max(2, H*W/500) keys differ, and the ids are equal wherever the keys
  are;
- compiled JAX end to end (``Renderer``): the pixel contract, 2 LSB;
- the port against itself: the fused and the deferred image of one frame
  are bitwise equal on both paths, as the JAX package holds its own
  (tests/test_textures.py:779-789).

The CUDA kernels are held against their twins only where a card exists.
"""

import os

import numpy as np
import pytest

from tests.test_torch_ext import (  # noqa: F401 (the small fixture)
    DT, EYE, LIGHTS, TILE, _jax_chain, _tile_bins, small,
)
from tests.test_torch_mip import (  # noqa: F401 (fixtures)
    _shading, frame, port_frame,
)
from tests.torch_parity import (  # noqa: F401 (fixtures)
    W, H, assert_frames_match, cuda_device, pixel_budget, port, tpu,
)

FILTERS = ["nearest", "bilinear", "trilinear", "anisotropic"]
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_data", "torch_mip_structured_1024x768.npz")
EFFECTS = {"none": np.zeros(6, np.float32),
           "mirage": np.array([4.0, 0.6, 0.05, 0.3, 1.0, 1.7], np.float32)}


def _winners(frame, seed=5):
    """A synthetic (H, W) winner map over the triangles a raster can pick
    (finite screen corners, nonzero area: the others have NaN
    barycentrics and cover nothing), a fifth of the pixels uncovered
    (NO_TRI)."""
    rng = np.random.default_rng(seed)
    v = frame["screen"][frame["tri"]]  # (T, 3, 4)
    with np.errstate(invalid="ignore"):  # non-finite corners: not live
        uz = ((v[:, 2, 0] - v[:, 0, 0]) * (v[:, 1, 1] - v[:, 0, 1])
              - (v[:, 1, 0] - v[:, 0, 0]) * (v[:, 2, 1] - v[:, 0, 1]))
        live = np.nonzero(np.isfinite(v[..., :2]).all(axis=(1, 2))
                          & (np.abs(uz) > 1e-3))[0]
    best = rng.choice(live, (H, W)).astype(np.int32)
    best[rng.random((H, W)) < 0.2] = -1
    return best


def _jax_resolve(tpu, frame, best, effect):
    jnp = tpu.jnp
    mesh = frame["mesh"]
    with tpu.jax.disable_jit():
        g = tpu.common.resolve_attributes(
            jnp.asarray(best), jnp.asarray(frame["tri"]),
            jnp.asarray(frame["screen"]), jnp.asarray(frame["world"]),
            jnp.asarray(mesh.normals), jnp.asarray(mesh.uvs),
            jnp.asarray(EFFECTS[effect]), W, H)
    return {k: np.array(v) for k, v in g.items()}  # writable, for torch


def _port_resolve(port, frame, best, effect):
    t = port.torch
    mesh = frame["mesh"]
    return port.common.resolve_attributes(
        t.from_numpy(best), t.from_numpy(frame["tri"]),
        t.from_numpy(frame["screen"]), t.from_numpy(frame["world"]),
        t.from_numpy(mesh.normals), t.from_numpy(mesh.uvs),
        t.from_numpy(EFFECTS[effect]), W, H)


@pytest.mark.parametrize("effect", ["none", "mirage"])
def test_resolve_attributes_bitwise(port, tpu, frame, effect):
    best = _winners(frame)
    a = _jax_resolve(tpu, frame, best, effect)
    b = _port_resolve(port, frame, best, effect)
    np.testing.assert_array_equal(a["flag"], b["flag"].numpy())
    for k in ("uv", "normal", "world_pos"):
        assert b[k].shape == a[k].shape
        np.testing.assert_array_equal(a[k].view(np.int32),
                                      b[k].numpy().view(np.int32), k)
    assert not b["uv"].numpy()[best < 0].any()


def _tex_inputs(frame, tex_filter):
    """(texels, tex_table, tex_mips) as the engines upload them."""
    mesh = frame["mesh"]
    if tex_filter in ("trilinear", "anisotropic"):
        return frame["pool"], mesh.tex_table, frame["mips"]
    return mesh.texels, mesh.tex_table, None


@pytest.mark.parametrize("tex_filter", FILTERS)
def test_sample_atlas_vs_jax(port, tpu, frame, tex_filter):
    # The deferred samplers on the same winners and uv.
    best = _winners(frame, 6)
    g = _jax_resolve(tpu, frame, best, "none")
    texels, table, mips = _tex_inputs(frame, tex_filter)
    face_tex = frame["mesh"].face_tex
    jnp, t = tpu.jnp, port.torch
    flag = best >= 0
    with tpu.jax.disable_jit():
        if mips is None:
            ta, ha = tpu.common.sample_atlas(
                jnp.asarray(texels), jnp.asarray(table), jnp.asarray(face_tex),
                jnp.asarray(best), jnp.asarray(flag), jnp.asarray(g["uv"]),
                bilinear=tex_filter == "bilinear")
        else:
            ta, ha = tpu.common.sample_atlas_mip(
                jnp.asarray(texels), jnp.asarray(mips), jnp.asarray(face_tex),
                jnp.asarray(best), jnp.asarray(flag), jnp.asarray(g["uv"]),
                jnp.asarray(frame["guv"]), tex_filter)
    if mips is None:
        tb, hb = port.common.sample_atlas(
            t.from_numpy(texels), t.from_numpy(table),
            t.from_numpy(face_tex), t.from_numpy(best), t.from_numpy(flag),
            t.from_numpy(g["uv"]), bilinear=tex_filter == "bilinear")
    else:
        tb, hb = port.common.sample_atlas_mip(
            t.from_numpy(texels), t.from_numpy(mips), t.from_numpy(face_tex),
            t.from_numpy(best), t.from_numpy(flag), t.from_numpy(g["uv"]),
            t.from_numpy(frame["guv"]), tex_filter)
    np.testing.assert_array_equal(np.asarray(ha), hb.numpy())
    assert hb.numpy().sum() > 10000
    if mips is None:
        np.testing.assert_array_equal(np.asarray(ta), tb.numpy())
    else:
        np.testing.assert_allclose(np.asarray(ta), tb.numpy(), rtol=0,
                                   atol=1e-5)
    assert (tb.numpy()[~hb.numpy()] == 1.0).all()


@pytest.mark.parametrize("tex_filter", FILTERS)
def test_textured_shade_vs_jax(port, tpu, frame, tex_filter):
    best = _winners(frame, 7)
    ga = _jax_resolve(tpu, frame, best, "none")
    gb = _port_resolve(port, frame, best, "none")
    texels, table, mips = _tex_inputs(frame, tex_filter)
    mesh = frame["mesh"]
    mip = mips is not None
    jnp, t = tpu.jnp, port.torch
    with tpu.jax.disable_jit():
        a = tpu.common.textured_shade(
            {k: jnp.asarray(v) for k, v in ga.items()}, jnp.asarray(best),
            jnp.asarray(mesh.face_kd), jnp.asarray(mesh.face_tex),
            jnp.asarray(texels), jnp.asarray(table),
            jnp.asarray(frame["vpos"]), *[jnp.asarray(x) for x in LIGHTS],
            tex_filter=tex_filter,
            tex_mips=jnp.asarray(mips) if mip else None,
            guv=jnp.asarray(frame["guv"]) if mip else None)
    b = port.common.textured_shade(
        gb, t.from_numpy(best), t.from_numpy(mesh.face_kd),
        t.from_numpy(mesh.face_tex), t.from_numpy(texels),
        t.from_numpy(table), t.from_numpy(frame["vpos"]),
        *[t.from_numpy(x) for x in LIGHTS], tex_filter=tex_filter,
        tex_mips=t.from_numpy(mips) if mip else None,
        guv=t.from_numpy(frame["guv"]) if mip else None)
    a, b = np.asarray(a), b.numpy()
    assert b.dtype == np.uint8 and b.shape == (H, W, 4)
    if mip:
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
    else:
        np.testing.assert_array_equal(a, b)
    assert (b[best < 0] == [0, 0, 255, 255]).all()


def _compare_vis(out_a, key_a, out_b, key_b, no_id):
    """Ids and keys of the two packages (see the module docstring)."""
    key_a, key_b = np.asarray(key_a), np.asarray(key_b)
    out_a, out_b = np.asarray(out_a), np.asarray(out_b)
    assert out_b.dtype == np.int32
    assert int((key_a != key_b).sum()) <= pixel_budget(*key_a.shape)
    covered = key_b != 0xFFFFFFFF
    assert covered.sum() > 2000
    same = key_a == key_b
    np.testing.assert_array_equal(out_a[same], out_b[same])
    assert (out_b[~covered] == no_id).all()
    assert (out_b[covered] != no_id).all()


@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_tile_twin_vis_vs_pallas_raster(port, tpu, small, layout):
    f = _frame_ext(tpu, small)
    _, _, setup, table = _jax_chain(tpu, f, "mat", TILE)
    table = np.ascontiguousarray(table[:, :32])  # the vis table is the base
    data, starts, counts, tile_cap, (hp, wp) = _tile_bins(
        tpu, setup, layout, table.shape[0])
    jnp, t = tpu.jnp, port.torch
    shading = (f["eff"], f["vpos"], *LIGHTS)
    out_a, key_a = tpu.pallas_raster.raster_shade_tiles(
        jnp.asarray(table), jnp.asarray(data), jnp.asarray(starts),
        jnp.asarray(counts), *[jnp.asarray(x) for x in shading],
        height_padded=hp, width_padded=wp, tile_h=TILE[0], tile_w=TILE[1],
        tile_cap=tile_cap, layout=layout, interpret=True, worklist=True,
        vis=True)
    out_b, key_b = port.raster.raster_shade_tiles(
        *[t.from_numpy(np.ascontiguousarray(a))
          for a in (table, data, starts, counts, *shading)],
        height_padded=hp, width_padded=wp, tile_h=TILE[0], tile_w=TILE[1],
        layout=layout, mode="vis")
    assert key_b.dtype == t.uint32
    _compare_vis(out_a, key_a, out_b.numpy(), key_b.numpy(), -1)


def test_micro_twin_vis_vs_pallas_micro(port, tpu, small):
    f = _frame_ext(tpu, small)
    _, meta, setup, table = _jax_chain(tpu, f, "mat", (8, 8))
    table = np.ascontiguousarray(table[:, :32])
    ntx, nty = (W + 127) // 128, (H + 7) // 8
    pair_cap = max(int(meta[3].sum()), ntx * nty * 16, 1024)
    jnp, t = tpu.jnp, port.torch
    bins = tpu.binning.bin_cells_sort(setup, ntx, nty, pair_cap,
                                      interpret=True)
    assert not int(bins["pair_needed"])
    coeffs = tpu.pallas_micro.build_pair_coeffs(jnp.asarray(table),
                                                bins["pair_tri"])
    shading = (f["eff"], f["vpos"], *LIGHTS)
    out_a, key_a = tpu.pallas_micro.raster_shade_micro(
        coeffs, *[bins[k] for k in ("seg_start", "seg_count", "win_start",
                                    "tile_count")],
        *[jnp.asarray(x) for x in shading], height_padded=nty * 8,
        width_padded=ntx * 128, interpret=True, vis=True)
    dev = lambda a: t.from_numpy(np.array(a))  # a writable copy
    out_b, key_b = port.micro.raster_shade_micro(
        dev(table), *[dev(bins[k]) for k in ("pair_tri", "seg_start",
                                             "seg_count", "tile_count")],
        *[dev(x) for x in shading], height_padded=nty * 8,
        width_padded=ntx * 128, mode="vis")
    clear = port.raster.PAIR_IDX_CLEAR
    _compare_vis(out_a, key_a, out_b.numpy(), key_b.numpy(), clear)
    pair_tri = np.asarray(bins["pair_tri"])
    ids = out_b.numpy()[key_b.numpy() != 0xFFFFFFFF]
    assert (ids < pair_tri.shape[0]).all() and (pair_tri[ids] >= 0).all()


def _frame_ext(tpu, small):
    from tests.test_torch_ext import _frame

    return _frame(tpu, small["mesh"])


def _scenes(port, tpu, small, tex_filter):
    out = []
    for pkg in (tpu, port):
        cfg = pkg.scene.SceneConfig(
            model_path=str(small["path"]),
            camera_config=pkg.scene.CameraConfig.first_person(EYE),
            enable_textures=True, texture_filter=tex_filter)
        out.append(pkg.scene.Scene.from_config(cfg, W, H))
    return out


@pytest.mark.parametrize("path", ["tile", "micro"])
@pytest.mark.parametrize("tex_filter", ["nearest", "trilinear"])
def test_renderer_deferred_vs_jax(port, tpu, small, tex_filter, path):
    # tex_mode="deferred" in both engines: compiled JAX against the twins.
    js, ts = _scenes(port, tpu, small, tex_filter)
    jr = tpu.renderer.Renderer(js.mesh, W, H, backend="tpu", path=path,
                               tex_mode="deferred", **js.renderer_options())
    tr = port.renderer.Renderer(ts.mesh, W, H, device="cpu", path=path,
                                tex_mode="deferred", **ts.renderer_options())
    assert port.cuda.frame_mode(
        tr.ext["face_kd"], tr.ext["texels"], tr.ext["tex_filter"],
        tr.ext["tex_mode"]) == "vis"
    for _ in range(2):
        a = jr.render(js.update(DT))
        b = tr.render(ts.update(DT))
        assert b.shape == (H, W, 4) and b.dtype == np.uint8
        assert_frames_match(a, b)


@pytest.mark.parametrize("path", ["tile", "micro"])
@pytest.mark.parametrize("tex_filter", FILTERS)
def test_fused_equals_deferred(port, small, tex_filter, path):
    # The port's own contract: one frame, fused and deferred, bitwise.
    cfg = port.scene.SceneConfig(
        model_path=str(small["path"]),
        camera_config=port.scene.CameraConfig.first_person(EYE),
        enable_textures=True, texture_filter=tex_filter)
    s = port.scene.Scene.from_config(cfg, W, H)
    u = s.update(DT)
    imgs = []
    for tex_mode in ("fused", "deferred"):
        r = port.renderer.Renderer(s.mesh, W, H, device="cpu", path=path,
                                   tex_mode=tex_mode,
                                   **s.renderer_options())
        imgs.append(r.render(u))
    np.testing.assert_array_equal(imgs[0], imgs[1])
    assert (imgs[0] != [0, 0, 255, 255]).any(axis=-1).sum() > 10000


def test_chunked_vis_merge_matches_single_pass(port, small):
    # path="tile" with a small tri_chunk offsets each chunk's winner ids
    # by its first triangle before the depth merge: the same frame.
    cfg = port.scene.SceneConfig(
        model_path=str(small["path"]),
        camera_config=port.scene.CameraConfig.first_person(EYE),
        enable_textures=True)
    s = port.scene.Scene.from_config(cfg, W, H)
    u = s.update(DT)
    single = port.renderer.Renderer(s.mesh, W, H, device="cpu", path="tile",
                                    tex_mode="deferred")
    chunked = port.renderer.Renderer(s.mesh, W, H, device="cpu",
                                     path="tile", tex_mode="deferred",
                                     tri_chunk=1500)
    for r in (single, chunked):
        r.render(u)  # settles the capacities (the retry)
    a, b = single.render_device(u), chunked.render_device(u)
    assert not a[2].any() and not b[2].any()
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


def test_deferred_routing(port, small):
    # On the tex_table alone: nearest and bilinear take the deferred mode
    # for an atlas of 2^24 texels or more (no such atlas is built: the
    # decision reads the offsets), and fused below it; tex_mode="deferred"
    # takes it always.
    mesh = small["mesh"]
    t = port.torch
    big = np.array([[0, 4, 4], [(1 << 24) - 1, 1, 1], [1 << 24, 1, 1]],
                   np.int32)
    far = port.convert.mesh_from_arrays(
        mesh.positions, mesh.normals, mesh.uvs, mesh.indices,
        face_kd=mesh.face_kd, face_tex=np.zeros_like(mesh.face_tex),
        texels=np.ones((1, 3), np.float32), tex_table=big)
    tri = t.from_numpy(mesh.indices.astype(np.int32).reshape(-1, 3))
    for m, options, mode in (
            (far, {}, "vis"), (far, {"tex_filter": "bilinear"}, "vis"),
            (mesh, {}, "texf"), (mesh, {"tex_mode": "deferred"}, "vis"),
            (mesh, {"tex_mode": "deferred", "tex_filter": "anisotropic"},
             "vis")):
        ext = port.cuda.mesh_ext_tensors(m, tri, "cpu", **options)
        assert port.cuda.frame_mode(
            ext["face_kd"], ext["texels"], ext["tex_filter"],
            ext["tex_mode"]) == mode, (options, mode)
        assert ("uv_soa" in ext) == (mode != "vis")
    with pytest.raises(ValueError):
        port.cuda.mesh_ext_tensors(mesh, tri, "cpu", tex_mode="lazy")


def test_structured_tex_deferred_golden_frame(port):
    # The golden file's tile vis row (structured_scene_tex.obj, 36,322
    # triangles, 1024x768, nearest, tex_mode="deferred") through the CPU
    # twins against the JAX package's frame (scripts/
    # make_torch_mip_golden.py).
    golden = np.load(GOLDEN)["tex_deferred"]
    cfg = port.scene.SceneConfig(
        model_path="structured_scene_tex.obj",
        camera_config=port.scene.CameraConfig.first_person(EYE),
        enable_textures=True)
    s = port.scene.Scene.from_config(cfg, 1024, 768)
    assert port.cuda.resolve_path("auto", s.total_tris) == "tile"
    r = port.renderer.Renderer(s.mesh, 1024, 768, device="cpu",
                               tex_mode="deferred", **s.renderer_options())
    assert_frames_match(golden[0], r.render(s.update(DT)))


def _port_base_table(port, f, tile, device):
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a)).to(device)
    table, meta = port.front.front_end(
        dev(f["pos_soa"]), dev(f["nrm_soa"]), dev(f["vp"]), dev(f["eff"]),
        width=W, height=H, tile_h=tile[0], tile_w=tile[1])
    assert port.raster.kernel_table(table)[0].data_ptr() == table.data_ptr()
    return table, meta


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "flat"])
def test_tile_raster_vis_on_card(port, small, cuda_device, layout):
    # Ids and keys bitwise against the twin on the same card tensors.
    f = _frame_ext(port, small)
    table, meta = _port_base_table(port, f, TILE, cuda_device)
    setup = port.binning.setup_from_meta(meta)
    ntx, nty = (W + 255) // 256, (H + 15) // 16
    need = port.binning.exact_tile_counts(setup, ntx, nty)
    binner = (port.binning.bin_triangles_dense if layout == "dense"
              else port.binning.bin_triangles_sort)
    bins = binner(setup, ntx, nty, int(need.sum()), int(need.max()))
    data = bins["bin_rows" if layout == "dense" else "pair_tri"]
    t = port.torch
    shading = [t.from_numpy(a).to(cuda_device)
               for a in (f["eff"], f["vpos"], *LIGHTS)]
    kw = dict(height_padded=nty * 16, width_padded=ntx * 256, tile_h=16,
              tile_w=256, layout=layout, mode="vis")
    before = port.tracing.count("launches.raster_shade_tiles.vis")
    out_k, key_k = port.raster.raster_shade_tiles(
        table, data, bins["seg_start"], bins["seg_count"], *shading, **kw)
    assert port.tracing.count("launches.raster_shade_tiles.vis") == before + 1
    params, lights = port.raster.shading_inputs(*shading)
    out_p, key_p = port.raster.raster_shade_tiles_plain(
        table, data, bins["seg_start"], bins["seg_count"], params, lights,
        **kw)
    assert t.equal(key_k.view(t.int32).cpu(), key_p.cpu())
    assert t.equal(out_k.cpu(), out_p.cpu())
    assert int((out_p >= 0).sum()) > 2000


@pytest.mark.cuda
def test_micro_vis_on_card(port, small, cuda_device):
    f = _frame_ext(port, small)
    table, meta = _port_base_table(port, f, (8, 8), cuda_device)
    ntx, nty = (W + 127) // 128, (H + 7) // 8
    pair_cap = max(int(meta[3].sum()), ntx * nty * 16, 1024)
    bins = port.binning.bin_cells_sort_meta(meta[3], meta[2], meta[0],
                                            meta[1], ntx, nty, pair_cap)
    t = port.torch
    shading = [t.from_numpy(a).to(cuda_device)
               for a in (f["eff"], f["vpos"], *LIGHTS)]
    margs = (table, bins["pair_tri"], bins["seg_start"], bins["seg_count"])
    kw = dict(height_padded=nty * 8, width_padded=ntx * 128, mode="vis")
    before = port.tracing.count("launches.raster_shade_micro.vis")
    out_k, key_k = port.micro.raster_shade_micro(
        *margs, bins["tile_count"], *shading, **kw)
    assert port.tracing.count("launches.raster_shade_micro.vis") == before + 1
    params, lights = port.raster.shading_inputs(*shading)
    out_p, key_p = port.micro.raster_shade_micro_plain(*margs, params,
                                                       lights, **kw)
    assert t.equal(key_k.view(t.int32).cpu(), key_p.cpu())
    assert t.equal(out_k.cpu(), out_p.cpu())
    covered = key_p.cpu() != -1
    assert int(covered.sum()) > 2000
    assert bool((out_p.cpu()[~covered] == port.raster.PAIR_IDX_CLEAR).all())
