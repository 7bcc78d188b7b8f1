"""The mip-filtered texture mode (TEXF_MIP: the trilinear and anisotropic
filters) against the JAX package, on the small structured build of
tests/test_torch_ext.py (5,362 triangles, two map_Kd images) at 256x192,
first person at (13.566635, 4.0, 24.0).

Tolerances, by reference:

- the JAX chain run op by op (``jax.disable_jit()``, no FMA contraction):
  bitwise, NaN positions equal (their payloads may differ) — the mip
  pool and level table, ``uv_gradients(_soa)``, the front end's 46
  columns and ``fused_texture_tail_mip`` on the same G-buffer — except
  two columns of ``mip_tri_rows``: lod within ``LOD_ULPS`` (log2 of a
  square root, and XLA:CPU's log2 is not torch's: up to 10 ULP measured
  on this scene) and the anisotropic spread 1 - 1/n within
  ``SPREAD_ULPS`` (XLA:CPU's 1/x is not an IEEE division: 2 ULP
  measured);
- compiled JAX (XLA:CPU contracts mul+add into FMA): the uv gradients
  within ``GUV_RTOL`` of the largest gradient of their triangle (the
  contraction cancels in e2*g2 + e3*g3: 4.9e-5 measured here), the mip
  rows' tid, mu and mv bitwise, lod and spread within ``LOD_ATOL``;
- the Pallas kernels in interpret mode (contraction inside the kernel
  flips samples exactly on an edge): at most max(2, H*W/500) keys differ;
  where both G-buffers hold the same winner, the copied channels (kd and
  the mip rows) are bitwise and the interpolated ones within rtol 1e-4,
  atol 1e-5;
- compiled JAX end to end (``Renderer``): the pixel contract, 2 LSB.

The CUDA kernels are held against their twins only where a card exists.
"""

import os

import numpy as np
import pytest

from tests.test_torch_ext import (  # noqa: F401 (the small fixture)
    DT, EYE, LIGHTS, TILE, _tile_bins, small,
)
from tests.torch_parity import (  # noqa: F401 (fixtures)
    W, H, assert_frames_match, cuda_device, pixel_budget, port, tpu,
)

MIP_FILTERS = ["trilinear", "anisotropic"]
LOD_ULPS = 16
SPREAD_ULPS = 4
LOD_ATOL = 1e-4
GUV_RTOL = 1e-4
GOLDEN = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "golden_data", "torch_mip_structured_1024x768.npz")


def ulps(a, b):
    """Per-element ULP distance of two f32 arrays (same-sign lattice)."""
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    ia = np.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = np.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return np.abs(ia - ib)


def assert_bitwise_nan(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a.view(np.int32)[~nan],
                                  b.view(np.int32)[~nan])


def assert_rows_match(a, b, lod_ulps=LOD_ULPS):
    """(T, 5) mip rows: tid, mu, mv bitwise, lod and spread within ULPs,
    NaN positions equal."""
    for c in (0, 2, 3):
        assert_bitwise_nan(a[:, c], b[:, c])
    for c, limit in ((1, lod_ulps), (4, SPREAD_ULPS)):
        np.testing.assert_array_equal(np.isnan(a[:, c]), np.isnan(b[:, c]))
        keep = ~np.isnan(a[:, c])
        assert int(ulps(a[keep, c], b[keep, c]).max()) <= limit, c


def _jax_vertex(tpu, mesh, vp, eff):
    jnp = tpu.jnp
    with tpu.jax.disable_jit():
        world, screen = tpu.common.vertex_stage(
            jnp.asarray(mesh.positions), jnp.asarray(vp), jnp.asarray(eff),
            W, H)
    return np.array(world), np.array(screen)  # writable, for torch


def _mips(pkg_textures, mesh):
    return pkg_textures.trilinear_tex_arrays(mesh.texels, mesh.tex_table)


@pytest.fixture(scope="module")
def port_frame(port, small):
    """The first frame's numpy inputs, from the port alone (the card's
    machine has no JAX): mesh, indices, camera, no effect, the mip pool."""
    from compute_renderer_torch.io import textures

    mesh = small["mesh"]
    u = port.camera.Camera.first_person(list(EYE), aspect=W / H).uniform()
    pool, mips = _mips(textures, mesh)
    return {"mesh": mesh, "vp": np.asarray(u.view_proj, np.float32),
            "eff": np.zeros(6, np.float32),
            "vpos": np.asarray(u.view_position, np.float32),
            "tri": mesh.indices.astype(np.int32).reshape(-1, 3),
            "pool": pool, "mips": mips}


@pytest.fixture(scope="module")
def frame(port_frame, tpu):
    """``port_frame`` with the JAX package's per-vertex world and screen
    (bitwise the port's, tests/test_torch_stages.py), its mip pool and
    its (T, 4) uv gradients."""
    from compute_renderer_tpu.io import textures as jax_textures

    f = dict(port_frame)
    mesh, tri = f["mesh"], f["tri"]
    f["world"], f["screen"] = _jax_vertex(tpu, mesh, f["vp"], f["eff"])
    f["pool"], f["mips"] = _mips(jax_textures, mesh)
    jnp = tpu.jnp
    with tpu.jax.disable_jit():
        f["guv"] = np.array(tpu.common.uv_gradients(
            jnp.asarray(tri), jnp.asarray(f["screen"]),
            jnp.asarray(mesh.uvs)))
    return f


def _odd_atlas():
    """Three textures of odd and unit sizes (5x3, 1x7, 6x6), seeded."""
    rng = np.random.default_rng(3)
    texels = rng.uniform(0.0, 1.0, (15 + 7 + 36, 3)).astype(np.float32)
    return texels, np.array([[0, 5, 3], [15, 1, 7], [22, 6, 6]], np.int32)


@pytest.mark.parametrize("atlas", ["structured", "odd"])
def test_build_mips_equal_jax(port, small, atlas):
    # Array for array: the pool, its level table, and the helper.
    from compute_renderer_torch.io import textures as ours
    from compute_renderer_tpu.io import textures as theirs

    texels, table = ((small["mesh"].texels, small["mesh"].tex_table)
                     if atlas == "structured" else _odd_atlas())
    for fn in ("build_mips", "trilinear_tex_arrays"):
        pa, ma = getattr(theirs, fn)(texels, table)
        pb, mb = getattr(ours, fn)(texels, table)
        assert pb.dtype == np.float32 and mb.dtype == np.int32
        np.testing.assert_array_equal(pa, pb)
        np.testing.assert_array_equal(ma, mb)
    assert mb.shape[0] == table.shape[0] and mb.shape[1] > 1
    np.testing.assert_array_equal(mb[:, 0], table)  # level 0 stays put


def test_uv_gradients_vs_jax(port, tpu, frame):
    t, jnp = port.torch, tpu.jnp
    f = frame
    tri, screen, uvs = f["tri"], f["screen"], f["mesh"].uvs
    ours = port.common.uv_gradients(t.from_numpy(tri), t.from_numpy(screen),
                                    t.from_numpy(uvs)).numpy()
    assert ours.shape == (tri.shape[0], 4)
    assert_bitwise_nan(f["guv"], ours)
    # The corner-SoA form on the same floats: bitwise, in both packages.
    soa = tuple(tuple(t.from_numpy(screen[tri[:, k], c]) for c in range(4))
                for k in range(3))
    uv_c = t.from_numpy(np.ascontiguousarray(uvs[tri].transpose(1, 2, 0)))
    assert_bitwise_nan(ours, port.common.uv_gradients_soa(soa, uv_c).numpy())
    with tpu.jax.disable_jit():
        jsoa = tuple(tuple(jnp.asarray(screen[tri[:, k], c]) for c in range(4))
                     for k in range(3))
        theirs_soa = np.asarray(tpu.common.uv_gradients_soa(
            jsoa, jnp.asarray(uv_c.numpy())))
    assert_bitwise_nan(theirs_soa, ours)
    # Compiled JAX contracts e2*g2 + e3*g3 into an FMA.
    compiled = np.asarray(tpu.jax.jit(tpu.common.uv_gradients)(
        jnp.asarray(tri), jnp.asarray(screen), jnp.asarray(uvs)))
    keep = np.isfinite(ours).all(axis=1)
    scale = np.abs(ours[keep]).max(axis=1, keepdims=True)
    assert (np.abs(compiled[keep] - ours[keep]) <= GUV_RTOL * scale).all()


@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_mip_tri_rows_vs_jax(port, tpu, frame, tex_filter):
    t, jnp = port.torch, tpu.jnp
    f = frame
    face_tex = f["mesh"].face_tex
    args = (face_tex, f["mips"], f["guv"])
    ours = port.common.mip_tri_rows(*[t.from_numpy(a) for a in args],
                                    tex_filter).numpy()
    assert ours.shape == (face_tex.shape[0], 5)
    with tpu.jax.disable_jit():
        theirs = np.asarray(tpu.common.mip_tri_rows(
            *[jnp.asarray(a) for a in args], tex_filter))
    assert_rows_match(theirs, ours)
    compiled = np.asarray(tpu.jax.jit(
        tpu.common.mip_tri_rows, static_argnums=3)(
            *[jnp.asarray(a) for a in args], tex_filter))
    for c in (0, 2, 3):
        assert_bitwise_nan(compiled[:, c], ours[:, c])
    np.testing.assert_allclose(compiled[:, [1, 4]], ours[:, [1, 4]], rtol=0,
                               atol=LOD_ATOL)
    lod = ours[:, 1][~np.isnan(ours[:, 1])]  # NaN: degenerate corners
    assert (lod >= 0).all() and (lod <= f["mips"].shape[1] - 1).all()
    assert (lod > 0).sum() > 100  # the frame samples above level 0
    np.testing.assert_array_equal(ours[:, 0], face_tex.astype(np.float32))
    if tex_filter == "trilinear":
        assert not ours[:, 2:].any()
    else:
        assert (ours[:, 4] > 0).sum() > 100  # anisotropic spreads


def _mip_gbuffer(rng, h, w, num_lights, mips):
    """A synthetic TEXF_MIP G-buffer: uv over several periods, kd, slots of
    the table or untextured, lod over the levels, unit-ish tap axes and
    spreads, diff and spec; a tenth of the pixels uncovered (cleared)."""
    L = mips.shape[1]
    g = np.zeros((10 + 2 * num_lights, h, w), np.float32)
    g[0:2] = rng.uniform(-3.0, 3.0, (2, h, w))
    g[2:5] = rng.uniform(0.0, 1.0, (3, h, w))
    g[5] = rng.integers(-1, mips.shape[0], (h, w))
    g[6] = rng.uniform(0.0, L - 1, (h, w))
    g[7:9] = rng.uniform(-0.02, 0.02, (2, h, w))
    g[9] = rng.choice([0.0, 0.5, 0.75], (h, w))
    g[10:] = rng.uniform(0.0, 1.0, (2 * num_lights, h, w))
    key = rng.integers(0, 2**31, (h, w)).astype(np.uint32)
    clear = rng.random((h, w)) < 0.1
    key[clear] = 0xFFFFFFFF
    g[:, clear] = 0.0
    return g, key


@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_fused_texture_tail_mip_bitwise(port, tpu, frame, tex_filter):
    # The same G-buffer through both tails, JAX op by op: bitwise.
    g, key = _mip_gbuffer(np.random.default_rng(11), 48, 64, 2,
                          frame["mips"])
    jnp, t = tpu.jnp, port.torch
    with tpu.jax.disable_jit():
        a = tpu.common.fused_texture_tail_mip(
            jnp.asarray(g), jnp.asarray(key), jnp.asarray(frame["pool"]),
            jnp.asarray(frame["mips"]), jnp.asarray(LIGHTS[1]),
            jnp.asarray(LIGHTS[2]), tex_filter=tex_filter)
    b = port.common.fused_texture_tail_mip(
        t.from_numpy(g), t.from_numpy(key.view(np.int32)).view(t.uint32),
        t.from_numpy(frame["pool"]), t.from_numpy(frame["mips"]),
        t.from_numpy(LIGHTS[1]), t.from_numpy(LIGHTS[2]),
        tex_filter=tex_filter)
    assert b.dtype == t.uint8 and b.shape == (48, 64, 4)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (b.numpy()[key == 0xFFFFFFFF] == [0, 0, 255, 255]).all()


def _jax_mip_chain(tpu, f, tex_filter, tile):
    """The JAX package's 46-column chain, op by op (corner SoA, as its
    micro path builds it): coeff (46, T), meta, setup, table (T, 46)."""
    jnp = tpu.jnp
    mesh, tri = f["mesh"], f["tri"]
    with tpu.jax.disable_jit():
        pos_soa = jnp.asarray(mesh.positions[tri].transpose(1, 2, 0))
        world, screen = tpu.common.vertex_stage_soa(
            pos_soa, jnp.asarray(f["vp"]), jnp.asarray(f["eff"]), W, H)
        setup = tpu.common.triangle_setup_soa(screen, jnp.asarray(f["eff"]),
                                              W, H, *tile)
        nrm_soa = jnp.asarray(mesh.normals[tri].transpose(1, 2, 0))
        nrm = tuple(tuple(nrm_soa[k, c] for c in range(3)) for k in range(3))
        uv = jnp.asarray(mesh.uvs[tri].transpose(1, 2, 0))
        rows = tpu.common.mip_tri_rows(
            jnp.asarray(mesh.face_tex), jnp.asarray(f["mips"]),
            tpu.common.uv_gradients_soa(screen, uv), tex_filter)
        cols = tpu.pallas_raster.tri_table_columns(
            screen, nrm, world, face_kd=jnp.asarray(mesh.face_kd),
            uv_soa=tuple(tuple(uv[k, c] for c in range(2))
                         for k in range(3)),
            tex_rows=rows)
        rx, _, c = tpu.binning.cover_counts(setup)
        meta = np.stack([np.asarray(setup["tile_x0"]),
                         np.asarray(setup["tile_y0"]), np.asarray(rx),
                         np.asarray(c)]).astype(np.int32)
    coeff = np.stack([np.asarray(r) for r in cols])
    return coeff, meta, setup, np.ascontiguousarray(coeff.T)


def _port_mip_front(port, f, tex_filter, tile, device="cpu", fn=None):
    """The port's own chain: mip rows from its vertex stage, then the
    front end in texf_mip mode. Returns (table (T, 46), meta, mip
    rows)."""
    t = port.torch
    mesh, tri = f["mesh"], f["tri"]
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a)).to(device)
    vp, eff = dev(f["vp"]), dev(f["eff"])
    _, screen = port.common.vertex_stage(dev(mesh.positions), vp, eff, W, H)
    guv = port.common.uv_gradients(dev(tri), screen, dev(mesh.uvs))
    rows = port.common.mip_tri_rows(dev(mesh.face_tex), dev(f["mips"]), guv,
                                    tex_filter)
    fn = fn or port.front.front_end
    table, meta = fn(
        dev(mesh.positions[tri].transpose(1, 2, 0)),
        dev(mesh.normals[tri].transpose(1, 2, 0)), vp, eff, width=W,
        height=H, tile_h=tile[0], tile_w=tile[1], kd_rows=dev(mesh.face_kd),
        uv_soa=dev(mesh.uvs[tri].transpose(1, 2, 0)), mip_rows=rows)
    return table, meta, rows


@pytest.mark.parametrize("tile", [TILE, (8, 8)])
@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_front_texf_mip_vs_xla_chain(port, tpu, frame, tex_filter, tile):
    ca, ma, _, _ = _jax_mip_chain(tpu, frame, tex_filter, tile)
    cb, mb, _ = _port_mip_front(port, frame, tex_filter, tile)
    cb = cb.numpy()  # the port's (T, 46) table; JAX's rows are (46, T)
    assert cb.shape == ca.T.shape == (frame["tri"].shape[0], 46)
    np.testing.assert_array_equal(ma, mb.numpy())
    others = [c for c in range(46) if c not in (42, 45)]
    assert_bitwise_nan(ca[others].T, cb[:, others])
    assert_rows_match(ca[41:46].T, cb[:, 41:46])


def _compare_mip_outputs(port, tpu, frame, tex_filter, out_a, key_a, out_b,
                         key_b):
    """Kernel-level outputs of the two packages (see the module
    docstring), then the frames the fused tail makes of them."""
    key_a, key_b = np.asarray(key_a), np.asarray(key_b)
    assert int((key_a != key_b).sum()) <= pixel_budget(*key_a.shape)
    covered = key_b != 0xFFFFFFFF
    assert covered.sum() > 2000
    ga, gb = np.asarray(out_a), np.asarray(out_b)
    assert ga.shape == gb.shape == (14,) + key_a.shape
    same = covered & (key_a == key_b)
    np.testing.assert_array_equal(ga[2:10, same], gb[2:10, same])
    for c in (0, 1, 10, 11, 12, 13):
        np.testing.assert_allclose(gb[c, same], ga[c, same], rtol=1e-4,
                                   atol=1e-5)
    t, jnp = port.torch, tpu.jnp
    ra = tpu.common.fused_texture_tail_mip(
        jnp.asarray(ga), jnp.asarray(key_a), jnp.asarray(frame["pool"]),
        jnp.asarray(frame["mips"]), jnp.asarray(LIGHTS[1]),
        jnp.asarray(LIGHTS[2]), tex_filter=tex_filter)
    rb = port.common.fused_texture_tail_mip(
        t.from_numpy(gb), t.from_numpy(key_b.view(np.int32)),
        t.from_numpy(frame["pool"]), t.from_numpy(frame["mips"]),
        t.from_numpy(LIGHTS[1]), t.from_numpy(LIGHTS[2]),
        tex_filter=tex_filter)
    assert_frames_match(np.asarray(ra), rb.numpy())


def _shading(pkg_asarray, frame):
    return [pkg_asarray(a) for a in (frame["eff"], frame["vpos"], *LIGHTS)]


@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_tile_twin_texf_mip_vs_pallas_raster(port, tpu, frame, tex_filter,
                                             layout):
    _, _, setup, table = _jax_mip_chain(tpu, frame, tex_filter, TILE)
    data, starts, counts, tile_cap, (hp, wp) = _tile_bins(
        tpu, setup, layout, table.shape[0])
    jnp, t = tpu.jnp, port.torch
    out_a, key_a = tpu.pallas_raster.raster_shade_tiles(
        jnp.asarray(table), jnp.asarray(data), jnp.asarray(starts),
        jnp.asarray(counts), *_shading(jnp.asarray, frame), height_padded=hp,
        width_padded=wp, tile_h=TILE[0], tile_w=TILE[1], tile_cap=tile_cap,
        layout=layout, interpret=True, worklist=True,
        texf=tpu.pallas_micro.TEXF_MIP)
    out_b, key_b = port.raster.raster_shade_tiles(
        *[t.from_numpy(np.ascontiguousarray(a))
          for a in (table, data, starts, counts)],
        *_shading(t.from_numpy, frame), height_padded=hp, width_padded=wp,
        tile_h=TILE[0], tile_w=TILE[1], layout=layout, mode="texf_mip")
    assert out_b.dtype == t.float32 and key_b.dtype == t.uint32
    _compare_mip_outputs(port, tpu, frame, tex_filter, out_a, key_a,
                         out_b.numpy(), key_b.numpy())


@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_micro_twin_texf_mip_vs_pallas_micro(port, tpu, frame, tex_filter):
    _, meta, setup, table = _jax_mip_chain(tpu, frame, tex_filter, (8, 8))
    ntx, nty = (W + 127) // 128, (H + 7) // 8
    pair_cap = max(int(meta[3].sum()), ntx * nty * 16, 1024)
    jnp, t = tpu.jnp, port.torch
    bins = tpu.binning.bin_cells_sort(setup, ntx, nty, pair_cap,
                                      interpret=True)
    assert not int(bins["pair_needed"])
    coeffs = tpu.pallas_micro.build_pair_coeffs(jnp.asarray(table),
                                                bins["pair_tri"])
    out_a, key_a = tpu.pallas_micro.raster_shade_micro(
        coeffs, *[bins[k] for k in ("seg_start", "seg_count", "win_start",
                                    "tile_count")],
        *_shading(jnp.asarray, frame), height_padded=nty * 8,
        width_padded=ntx * 128, interpret=True,
        texf=tpu.pallas_micro.TEXF_MIP)
    dev = lambda a: t.from_numpy(np.array(a))  # a writable copy
    out_b, key_b = port.micro.raster_shade_micro(
        dev(table), *[dev(bins[k]) for k in ("pair_tri", "seg_start",
                                             "seg_count", "tile_count")],
        *_shading(dev, frame), height_padded=nty * 8, width_padded=ntx * 128,
        mode="texf_mip")
    _compare_mip_outputs(port, tpu, frame, tex_filter, out_a, key_a,
                         out_b.numpy(), key_b.numpy())


def _scenes(port, tpu, small, tex_filter, tex_mode="fused"):
    out = []
    for pkg in (tpu, port):
        cfg = pkg.scene.SceneConfig(
            model_path=str(small["path"]),
            camera_config=pkg.scene.CameraConfig.first_person(EYE),
            enable_textures=True, texture_filter=tex_filter)
        out.append(pkg.scene.Scene.from_config(cfg, W, H))
    return out


@pytest.mark.parametrize("path", ["tile", "micro"])
@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_renderer_mip_vs_jax(port, tpu, small, tex_filter, path):
    # Both engines pick TEXF_MIP; compiled JAX against the twins, 2 LSB.
    js, ts = _scenes(port, tpu, small, tex_filter)
    jr = tpu.renderer.Renderer(js.mesh, W, H, backend="tpu", path=path,
                               **js.renderer_options())
    tr = port.renderer.Renderer(ts.mesh, W, H, device="cpu", path=path,
                                **ts.renderer_options())
    assert port.cuda.frame_mode(
        tr.ext.get("face_kd"), tr.ext["texels"], tr.ext["tex_filter"],
        tr.ext["tex_mode"]) == "texf_mip"
    for _ in range(2):
        a = jr.render(js.update(DT))
        b = tr.render(ts.update(DT))
        assert b.shape == (H, W, 4) and b.dtype == np.uint8
        assert_frames_match(a, b)
    nearest = port.renderer.Renderer(ts.mesh, W, H, device="cpu", path=path)
    assert (nearest.render(ts.update(0.0)) != b).any()  # the filter shows


@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_mip_routing(port, small, tex_filter):
    # On the tex_table alone: a mip filter takes texf_mip with the mip pool
    # and its level table built once on the host; fused is the default.
    mesh = small["mesh"]
    t = port.torch
    tri = t.from_numpy(mesh.indices.astype(np.int32).reshape(-1, 3))
    ext = port.cuda.mesh_ext_tensors(mesh, tri, "cpu", tex_filter=tex_filter)
    assert ext["tex_mode"] == "fused" and "tex_rows" not in ext
    assert ext["texels"].shape[0] > mesh.texels.shape[0]  # the mip pool
    assert ext["tex_mips"].dtype == t.int32 and ext["tex_mips"].shape[:1] \
        == (mesh.tex_table.shape[0],)
    assert port.cuda.frame_mode(ext["face_kd"], ext["texels"], tex_filter,
                                ext["tex_mode"]) == "texf_mip"
    with pytest.raises(ValueError):
        port.cuda.mesh_ext_tensors(mesh, tri, "cpu", tex_filter="cubic")


def _structured_tex(port, **options):
    cfg = port.scene.SceneConfig(
        model_path="structured_scene_tex.obj",
        camera_config=port.scene.CameraConfig.first_person(EYE),
        enable_textures=True, **options)
    return port.scene.Scene.from_config(cfg, 1024, 768)


@pytest.mark.parametrize("row,tex_filter", [("tex_trilinear", "trilinear"),
                                            ("tex_anisotropic",
                                             "anisotropic")])
def test_structured_tex_mip_golden_frames(port, row, tex_filter):
    # The golden file's tile rows (structured_scene_tex.obj, 36,322
    # triangles, 1024x768) through the CPU twins against the JAX package's
    # frames (scripts/make_torch_mip_golden.py), first frame.
    golden = np.load(GOLDEN)[row]
    assert golden.shape[1:] == (768, 1024, 4)
    s = _structured_tex(port, texture_filter=tex_filter)
    assert port.cuda.resolve_path("auto", s.total_tris) == "tile"
    r = port.renderer.Renderer(s.mesh, 1024, 768, device="cpu",
                               **s.renderer_options())
    assert_frames_match(golden[0], r.render(s.update(DT)))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [TILE, (8, 8)])
@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_front_texf_mip_on_card(port, port_frame, cuda_device, tex_filter,
                                tile):
    # The kernel against its twin on the same card tensors: meta and all
    # 46 coefficient rows bitwise (NaN positions equal).
    frame = port_frame
    before = port.tracing.count("launches.front_end.texf_mip")
    ck, mk, _ = _port_mip_front(port, frame, tex_filter, tile, cuda_device)
    assert port.tracing.count("launches.front_end.texf_mip") == before + 1
    cp, mp, _ = _port_mip_front(port, frame, tex_filter, tile, cuda_device,
                                fn=port.front.front_end_plain)
    assert port.torch.equal(mk, mp)
    assert_bitwise_nan(ck.cpu().numpy(), cp.cpu().numpy())


def _card_gbuffers_equal(port, out_k, key_k, out_p, key_p):
    t = port.torch
    assert t.equal(key_k.view(t.int32).cpu(), key_p.view(t.int32).cpu())
    assert int((key_p.view(t.int32) != -1).sum()) > 2000
    # The planes where the key is set: they are undefined elsewhere.
    defined = port.raster.defined_planes
    assert t.equal(defined(out_k, key_k).cpu().view(t.int32),
                   defined(out_p, key_p).cpu().view(t.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_tile_raster_texf_mip_on_card(port, port_frame, cuda_device,
                                      tex_filter, layout):
    frame = port_frame
    table, meta, _ = _port_mip_front(port, frame, tex_filter, TILE,
                                     cuda_device)
    assert port.raster.kernel_table(table)[0].data_ptr() == table.data_ptr()
    setup = port.binning.setup_from_meta(meta)
    ntx, nty = (W + 255) // 256, (H + 15) // 16
    need = port.binning.exact_tile_counts(setup, ntx, nty)
    binner = (port.binning.bin_triangles_dense if layout == "dense"
              else port.binning.bin_triangles_sort)
    bins = binner(setup, ntx, nty, int(need.sum()), int(need.max()))
    data = bins["bin_rows" if layout == "dense" else "pair_tri"]
    t = port.torch
    shading = _shading(lambda a: t.from_numpy(a).to(cuda_device), frame)
    kw = dict(height_padded=nty * 16, width_padded=ntx * 256, tile_h=16,
              tile_w=256, layout=layout, mode="texf_mip")
    before = port.tracing.count("launches.raster_shade_tiles.texf_mip")
    out_k, key_k = port.raster.raster_shade_tiles(
        table, data, bins["seg_start"], bins["seg_count"], *shading, **kw)
    assert port.tracing.count("launches.raster_shade_tiles.texf_mip") == \
        before + 1
    params, lights = port.raster.shading_inputs(*shading)
    out_p, key_p = port.raster.raster_shade_tiles_plain(
        table, data, bins["seg_start"], bins["seg_count"], params, lights,
        **kw)
    _card_gbuffers_equal(port, out_k, key_k, out_p, key_p)


@pytest.mark.cuda
@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_micro_texf_mip_on_card(port, port_frame, cuda_device, tex_filter):
    frame = port_frame
    table, meta, _ = _port_mip_front(port, frame, tex_filter, (8, 8),
                                     cuda_device)
    ntx, nty = (W + 127) // 128, (H + 7) // 8
    pair_cap = max(int(meta[3].sum()), ntx * nty * 16, 1024)
    bins = port.binning.bin_cells_sort_meta(meta[3], meta[2], meta[0],
                                            meta[1], ntx, nty, pair_cap)
    t = port.torch
    shading = _shading(lambda a: t.from_numpy(a).to(cuda_device), frame)
    margs = (table, bins["pair_tri"], bins["seg_start"], bins["seg_count"])
    kw = dict(height_padded=nty * 8, width_padded=ntx * 128, mode="texf_mip")
    before = port.tracing.count("launches.raster_shade_micro.texf_mip")
    out_k, key_k = port.micro.raster_shade_micro(
        *margs, bins["tile_count"], *shading, **kw)
    assert port.tracing.count("launches.raster_shade_micro.texf_mip") == \
        before + 1
    params, lights = port.raster.shading_inputs(*shading)
    out_p, key_p = port.micro.raster_shade_micro_plain(*margs, params,
                                                       lights, **kw)
    _card_gbuffers_equal(port, out_k, key_k, out_p, key_p)
