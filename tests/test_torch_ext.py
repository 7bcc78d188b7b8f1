"""The material and fused-texture modes against the JAX package, on a small
build of the structured scene (io/objgen.py, 5,362 triangles with every
face-token form, three materials and two map_Kd images) at 256x192, first
person at (13.566635, 4.0, 24.0) as in bench/suite.py:101-144.

Tolerances, by reference:

- the JAX chain run op by op (``jax.disable_jit()``, no FMA contraction):
  bitwise — the front end's 35 / 44 coefficient rows, ``tex_rows_f32``,
  and ``fused_texture_tail`` on the same G-buffer;
- the Pallas kernels in interpret mode (XLA:CPU contracts mul+add into FMA
  inside them, which flips samples exactly on an edge): at most
  max(2, H*W/500) pixels may differ in coverage, in colour by more than
  1 LSB; where both G-buffers hold the same winner, the copied channels
  (kd, TextureInfo) are bitwise and the interpolated ones (uv, diff,
  spec) within rtol 1e-4, atol 1e-5 (contraction moves a normal or uv by
  a few ULP, the normalisations amplify that);
- compiled JAX end to end (``Renderer``): the pixel contract, 2 LSB.

The CUDA kernels are held against their twins only where a card exists.
"""

import os

import numpy as np
import pytest

from tests.torch_parity import (  # noqa: F401 (fixtures)
    W, H, assert_frames_match, cuda_device, pixel_budget, port, tpu,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_data",
                      "torch_ext_structured_1024x768.npz")
EYE = (13.566635, 4.0, 24.0)
DT = 1.0 / 60.0
LIGHTS = (np.array([[0.0, 0.0, 0.0], [-5.0, 3.0, 0.0]], np.float32),
          np.array([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5]], np.float32),
          np.array([1.0, 0.5], np.float32))
TILE = (16, 256)


@pytest.fixture(scope="module")
def small(tmp_path_factory):
    """The small structured build on disk and its textured mesh (numpy,
    loaded by the port; tests/test_torch_obj.py pins it to the JAX
    loader's bitwise)."""
    from compute_renderer_torch.io import objgen
    from compute_renderer_torch.io.obj import load_obj

    d = tmp_path_factory.mktemp("structured")
    path = d / "structured_small.obj"
    objgen.write_structured_obj(path, terrain_n=40, statue_nu=40,
                                statue_nv=24, ruins=20,
                                mtl_text=objgen._STRUCTURED_MTL)
    objgen._write_shared_textures(d)
    return {"path": path, "mesh": load_obj(path, textures=True)}


def _frame(pkg, mesh, width=W, height=H):
    """Numpy frame inputs of the small scene's first frame."""
    u = pkg.camera.Camera.first_person(list(EYE),
                                       aspect=width / height).uniform()
    tri = mesh.indices.astype(np.int32).reshape(-1, 3)
    return {
        "pos_soa": np.ascontiguousarray(mesh.positions[tri].transpose(1, 2, 0)),
        "nrm_soa": np.ascontiguousarray(mesh.normals[tri].transpose(1, 2, 0)),
        "uv_soa": np.ascontiguousarray(mesh.uvs[tri].transpose(1, 2, 0)),
        "vp": np.asarray(u.view_proj, np.float32),
        "vpos": np.asarray(u.view_position, np.float32),
        "eff": np.zeros(6, np.float32), "lights": LIGHTS,
        "kd": mesh.face_kd, "face_tex": mesh.face_tex,
        "tex_table": mesh.tex_table, "texels": mesh.texels,
    }


def _jax_tex_rows(tpu, f):
    jnp = tpu.jnp
    return tpu.common.tex_rows_f32(jnp.asarray(f["face_tex"]),
                                   jnp.asarray(f["tex_table"]))


def _jax_chain(tpu, f, mode, tile):
    """The JAX package's front chain, op by op: coeff (R, T), meta (4, T),
    the setup dict and the table (T, R)."""
    jnp = tpu.jnp
    with tpu.jax.disable_jit():
        vp, eff = jnp.asarray(f["vp"]), jnp.asarray(f["eff"])
        world, screen = tpu.common.vertex_stage_soa(
            jnp.asarray(f["pos_soa"]), vp, eff, W, H)
        setup = tpu.common.triangle_setup_soa(screen, eff, W, H, *tile)
        nrm_soa = jnp.asarray(f["nrm_soa"])
        nrm = tuple(tuple(nrm_soa[k, c] for c in range(3)) for k in range(3))
        kw = {"face_kd": jnp.asarray(f["kd"])}
        if mode == "texf":
            uv = jnp.asarray(f["uv_soa"])
            kw["uv_soa"] = tuple(tuple(uv[k, c] for c in range(2))
                                 for k in range(3))
            kw["tex_rows"] = _jax_tex_rows(tpu, f)
        cols = tpu.pallas_raster.tri_table_columns(screen, nrm, world, **kw)
        rx, _, c = tpu.binning.cover_counts(setup)
        meta = np.stack([np.asarray(setup["tile_x0"]),
                         np.asarray(setup["tile_y0"]), np.asarray(rx),
                         np.asarray(c)]).astype(np.int32)
    coeff = np.stack([np.asarray(r) for r in cols])
    return coeff, meta, setup, np.ascontiguousarray(coeff.T)


def _port_front(port, f, mode, tile, device="cpu", fn=None):
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a)).to(device)
    kw = {"kd_rows": dev(f["kd"])}
    if mode == "texf":
        kw["uv_soa"] = dev(f["uv_soa"])
        kw["tex_rows"] = port.common.tex_rows_f32(dev(f["face_tex"]),
                                                  dev(f["tex_table"]))
    fn = fn or port.front.front_end
    return fn(dev(f["pos_soa"]), dev(f["nrm_soa"]), dev(f["vp"]),
              dev(f["eff"]), width=W, height=H, tile_h=tile[0],
              tile_w=tile[1], **kw)


def _assert_bitwise_nan(a, b):
    nan = np.isnan(a)
    np.testing.assert_array_equal(nan, np.isnan(b))
    np.testing.assert_array_equal(a.view(np.int32)[~nan],
                                  b.view(np.int32)[~nan])


@pytest.mark.parametrize("tile", [TILE, (8, 8)])
@pytest.mark.parametrize("mode", ["mat", "texf"])
def test_front_modes_vs_xla_chain(port, tpu, small, mode, tile):
    f = _frame(tpu, small["mesh"])
    ca, ma, _, _ = _jax_chain(tpu, f, mode, tile)
    cb, mb = _port_front(port, f, mode, tile)
    width = {"mat": 35, "texf": 44}[mode]
    # The port's (T, R) table against the JAX package's (R, T) rows.
    assert cb.shape == ca.T.shape == (small["mesh"].num_triangles, width)
    np.testing.assert_array_equal(ma, mb.numpy())
    _assert_bitwise_nan(ca.T, cb.numpy())


@pytest.mark.parametrize("mode", ["mat", "texf"])
def test_front_modes_vs_pallas_front(port, tpu, small, mode):
    # pallas_front in interpret mode: meta bitwise on live triangles, the
    # copied kd / TextureInfo rows bitwise everywhere.
    f = _frame(tpu, small["mesh"])
    jnp = tpu.jnp
    kw = {"kd_rows": jnp.asarray(f["kd"])}
    if mode == "texf":
        kw.update(uv_soa=jnp.asarray(f["uv_soa"]),
                  tex_rows=_jax_tex_rows(tpu, f))
    ca, ma = tpu.pallas_front.front_end(
        jnp.asarray(f["pos_soa"]), jnp.asarray(f["nrm_soa"]),
        jnp.asarray(f["vp"]), jnp.asarray(f["eff"]), width=W, height=H,
        tile_h=8, tile_w=8, interpret=True, **kw)
    ca, ma = np.asarray(ca), np.asarray(ma)
    cb, mb = (a.numpy() for a in _port_front(port, f, mode, (8, 8)))
    live = ma[3] > 0
    assert live.sum() > 1000
    np.testing.assert_array_equal(ma[:, live], mb[:, live])
    copied = slice(32, 35) if mode == "mat" else slice(38, 44)
    np.testing.assert_array_equal(ca[copied].T, cb[:, copied])


def _tile_bins(tpu, setup, layout, T):
    ntx, nty = (W + TILE[1] - 1) // TILE[1], (H + TILE[0] - 1) // TILE[0]
    exact = int(np.asarray(tpu.binning.exact_tile_counts(setup, ntx,
                                                         nty)).max())
    tile_cap = max(exact, 8)
    pair_cap = max(tpu.binning.default_pair_cap(T, ntx * nty),
                   int(np.asarray(tpu.binning.cover_counts(setup)[2]).sum()))
    binner = (tpu.binning.bin_triangles_dense if layout == "dense"
              else tpu.binning.bin_triangles_sort)
    bins = binner(setup, ntx, nty, pair_cap, tile_cap)
    assert not int(bins["tile_needed"]) and not int(bins["pair_needed"])
    # Dense rows keep the JAX binner's padding to a multiple of 8 tiles:
    # its kernel DMAs eight rows at a time.
    data = np.array(bins["bin_rows" if layout == "dense" else "pair_tri"])
    return (data, np.array(bins["seg_start"]), np.array(bins["seg_count"]),
            tile_cap, (nty * TILE[0], ntx * TILE[1]))


def _compare_outputs(port, tpu, f, mode, out_a, key_a, out_b, key_b):
    """Kernel-level outputs of the two packages (see the module
    docstring); for texf also the frames the fused tail makes of them."""
    key_a, key_b = np.asarray(key_a), np.asarray(key_b)
    budget = pixel_budget(*key_a.shape)
    assert int((key_a != key_b).sum()) <= budget
    covered = key_b != 0xFFFFFFFF
    assert covered.sum() > 2000
    if mode == "mat":
        unpack = lambda p: np.asarray(p).view(np.uint8).reshape(
            *p.shape, 4)
        assert_frames_match(unpack(np.asarray(out_a)), unpack(out_b), lsb=1)
        return
    ga, gb = np.asarray(out_a), np.asarray(out_b)
    assert ga.shape == gb.shape == (12,) + key_a.shape
    same = covered & (key_a == key_b)
    np.testing.assert_array_equal(ga[2:8, same], gb[2:8, same])
    for c in (0, 1, 8, 9, 10, 11):
        np.testing.assert_allclose(gb[c, same], ga[c, same], rtol=1e-4,
                                   atol=1e-5)
    t, jnp = port.torch, tpu.jnp
    lc, li = LIGHTS[1], LIGHTS[2]
    for filt in ("nearest", "bilinear"):
        ra = tpu.common.fused_texture_tail(
            jnp.asarray(ga), jnp.asarray(key_a), jnp.asarray(f["texels"]),
            jnp.asarray(lc), jnp.asarray(li), tex_filter=filt)
        rb = port.common.fused_texture_tail(
            t.from_numpy(gb), t.from_numpy(key_b.view(np.int32)),
            t.from_numpy(f["texels"]), t.from_numpy(lc), t.from_numpy(li),
            tex_filter=filt)
        assert_frames_match(np.asarray(ra), rb.numpy())


@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("mode", ["mat", "texf"])
def test_tile_twin_modes_vs_pallas_raster(port, tpu, small, mode, layout):
    f = _frame(tpu, small["mesh"])
    _, _, setup, table = _jax_chain(tpu, f, mode, TILE)
    T = table.shape[0]
    data, starts, counts, tile_cap, (hp, wp) = _tile_bins(tpu, setup, layout,
                                                          T)
    jnp = tpu.jnp
    shading = (jnp.asarray(f["eff"]), jnp.asarray(f["vpos"]),
               *[jnp.asarray(a) for a in LIGHTS])
    out_a, key_a = tpu.pallas_raster.raster_shade_tiles(
        jnp.asarray(table), jnp.asarray(data), jnp.asarray(starts),
        jnp.asarray(counts), *shading, height_padded=hp, width_padded=wp,
        tile_h=TILE[0], tile_w=TILE[1], tile_cap=tile_cap, layout=layout,
        interpret=True, worklist=True, texf=mode == "texf")
    t = port.torch
    out_b, key_b = port.raster.raster_shade_tiles(
        *[t.from_numpy(np.ascontiguousarray(a)) for a in (
            table, data, starts, counts, f["eff"], f["vpos"], *LIGHTS)],
        height_padded=hp, width_padded=wp, tile_h=TILE[0], tile_w=TILE[1],
        layout=layout, mode=mode)
    assert key_b.dtype == t.uint32
    assert out_b.dtype == (t.float32 if mode == "texf" else t.uint32)
    _compare_outputs(port, tpu, f, mode, out_a, key_a, out_b.numpy(),
                     key_b.numpy())


@pytest.mark.parametrize("mode", ["mat", "texf"])
def test_micro_twin_modes_vs_pallas_micro(port, tpu, small, mode):
    f = _frame(tpu, small["mesh"])
    _, meta, setup, table = _jax_chain(tpu, f, mode, (8, 8))
    ntx, nty = (W + 127) // 128, (H + 7) // 8
    pair_cap = max(int(meta[3].sum()), ntx * nty * 16, 1024)
    jnp = tpu.jnp
    bins = tpu.binning.bin_cells_sort(setup, ntx, nty, pair_cap,
                                      interpret=True)
    assert not int(bins["pair_needed"])
    coeffs = tpu.pallas_micro.build_pair_coeffs(jnp.asarray(table),
                                                bins["pair_tri"])
    out_a, key_a = tpu.pallas_micro.raster_shade_micro(
        coeffs, *[bins[k] for k in ("seg_start", "seg_count", "win_start",
                                    "tile_count")],
        jnp.asarray(f["eff"]), jnp.asarray(f["vpos"]),
        *[jnp.asarray(a) for a in LIGHTS], height_padded=nty * 8,
        width_padded=ntx * 128, interpret=True, mat=mode == "mat",
        texf=mode == "texf")
    t = port.torch
    dev = lambda a: t.from_numpy(np.array(a))  # a writable copy
    out_b, key_b = port.micro.raster_shade_micro(
        dev(table), *[dev(bins[k]) for k in ("pair_tri", "seg_start",
                                             "seg_count", "tile_count")],
        *[dev(a) for a in (f["eff"], f["vpos"], *LIGHTS)],
        height_padded=nty * 8, width_padded=ntx * 128, mode=mode)
    _compare_outputs(port, tpu, f, mode, out_a, key_a, out_b.numpy(),
                     key_b.numpy())


def _gbuffer(rng, h, w, num_lights, tex_table):
    """A synthetic texf G-buffer: uv over several periods (negative ones
    included), kd, TextureInfo rows of the table or untextured, diff and
    spec in [0, 1]; a tenth of the pixels uncovered."""
    g = np.zeros((8 + 2 * num_lights, h, w), np.float32)
    g[0:2] = rng.uniform(-3.0, 3.0, (2, h, w))
    g[2:5] = rng.uniform(0.0, 1.0, (3, h, w))
    slot = rng.integers(-1, tex_table.shape[0], (h, w))
    rows = np.where((slot >= 0)[..., None], tex_table[np.maximum(slot, 0)],
                    0).astype(np.float32)
    g[5:8] = rows.transpose(2, 0, 1)
    g[8:] = rng.uniform(0.0, 1.0, (2 * num_lights, h, w))
    key = rng.integers(0, 2**31, (h, w)).astype(np.uint32)
    key[rng.random((h, w)) < 0.1] = 0xFFFFFFFF
    return g, key


@pytest.mark.parametrize("tex_filter", ["nearest", "bilinear"])
def test_fused_texture_tail_bitwise(port, tpu, small, tex_filter):
    # The same G-buffer through both tails, JAX op by op: bitwise.
    mesh = small["mesh"]
    g, key = _gbuffer(np.random.default_rng(9), 48, 64, 2, mesh.tex_table)
    jnp, t = tpu.jnp, port.torch
    with tpu.jax.disable_jit():
        a = tpu.common.fused_texture_tail(
            jnp.asarray(g), jnp.asarray(key), jnp.asarray(mesh.texels),
            jnp.asarray(LIGHTS[1]), jnp.asarray(LIGHTS[2]),
            tex_filter=tex_filter)
    b = port.common.fused_texture_tail(
        t.from_numpy(g), t.from_numpy(key.view(np.int32)).view(t.uint32),
        t.from_numpy(mesh.texels), t.from_numpy(LIGHTS[1]),
        t.from_numpy(LIGHTS[2]), tex_filter=tex_filter)
    assert b.dtype == t.uint8 and b.shape == (48, 64, 4)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (b.numpy()[key == 0xFFFFFFFF] == [0, 0, 255, 255]).all()


def test_tex_rows_and_eligibility(port, tpu, small):
    mesh = small["mesh"]
    jnp, t = tpu.jnp, port.torch
    a = tpu.common.tex_rows_f32(jnp.asarray(mesh.face_tex),
                                jnp.asarray(mesh.tex_table))
    b = port.common.tex_rows_f32(t.from_numpy(mesh.face_tex),
                                 t.from_numpy(mesh.tex_table))
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (b.numpy()[mesh.face_tex < 0] == 0).all()
    big = np.array([[0, 4, 4], [(1 << 24) - 1, 1, 1], [1 << 24, 1, 1]],
                   np.int32)
    for table in (mesh.tex_table, big[:2], big, np.zeros((0, 3), np.int32)):
        assert port.cuda.texf_eligible(table) == \
            tpu.backend.texf_eligible(table)
    assert not port.cuda.texf_eligible(big)
    far = port.convert.mesh_from_arrays(
        mesh.positions, mesh.normals, mesh.uvs, mesh.indices,
        face_kd=mesh.face_kd, face_tex=np.zeros_like(mesh.face_tex),
        texels=np.ones((1, 3), np.float32), tex_table=big)
    # Such an atlas takes the deferred (vis) mode, as tpu.render decides.
    ext = port.renderer.Renderer(far, W, H, device="cpu").ext
    assert ext["tex_mode"] == "deferred" and "tex_rows" not in ext


# (materials, textures, tex_filter, ssaa, path): the suite's rows at the
# small build's size, on both paths.
RENDER_CASES = [
    ("materials", "tile", "nearest", 1), ("materials", "micro", "nearest", 1),
    ("textures", "tile", "nearest", 1), ("textures", "micro", "nearest", 1),
    ("textures", "tile", "bilinear", 2),
    ("textures", "micro", "bilinear", 1),
]


@pytest.mark.parametrize("ext,path,tex_filter,ssaa", RENDER_CASES)
def test_renderer_vs_jax(port, tpu, small, ext, path, tex_filter, ssaa):
    scenes = []
    for pkg in (tpu, port):
        cfg = pkg.scene.SceneConfig(
            model_path=str(small["path"]),
            camera_config=pkg.scene.CameraConfig.first_person(EYE),
            enable_materials=ext == "materials",
            enable_textures=ext == "textures", texture_filter=tex_filter,
            ssaa=ssaa)
        scenes.append(pkg.scene.Scene.from_config(cfg, W, H))
    js, ts = scenes
    assert (ts.mesh.face_kd is not None) and \
        ts.mesh.has_textures == (ext == "textures")
    jr = tpu.renderer.Renderer(js.mesh, W, H, backend="tpu", path=path,
                               **js.renderer_options())
    tr = port.renderer.Renderer(ts.mesh, W, H, device="cpu", path=path,
                                **ts.renderer_options())
    for _ in range(2):
        a = jr.render(js.update(DT))
        b = tr.render(ts.update(DT))
        assert b.shape == (H, W, 4) and b.dtype == np.uint8
        assert_frames_match(a, b)
    plain = port.renderer.Renderer(
        port.convert.mesh_from_arrays(ts.mesh.positions, ts.mesh.normals,
                                      ts.mesh.uvs, ts.mesh.indices),
        W, H, device="cpu", path=path, ssaa=ssaa)
    assert (plain.render(ts.update(0.0)) != b).any()  # the mode shows


def test_host_level_render_textured(port, tpu, small):
    # cuda.render, the host-level entry, on the textured mesh, against the
    # JAX package's tpu.render (both fused texturing).
    mesh = small["mesh"]
    cam = port.camera.Camera.first_person(list(EYE), aspect=W / H)
    eff = np.zeros(6, np.float32)
    a = tpu.backend.render(mesh, cam.uniform(), LIGHTS, eff, W, H,
                           tex_filter="bilinear")
    b = port.cuda.render(mesh, cam.uniform(), LIGHTS, eff, W, H,
                         device="cpu", tex_filter="bilinear")
    assert_frames_match(a, b)


def test_chunked_texf_merge_matches_single_pass(port, small):
    # path="tile" with a small tri_chunk merges the chunks' G-buffers
    # channel-wise by depth key: the same frame as one pass.
    mesh = small["mesh"]
    cfg = port.scene.SceneConfig(
        model_path=str(small["path"]),
        camera_config=port.scene.CameraConfig.first_person(EYE),
        enable_textures=True)
    s = port.scene.Scene.from_config(cfg, W, H)
    u = s.update(DT)
    single = port.renderer.Renderer(mesh, W, H, device="cpu", path="tile")
    chunked = port.renderer.Renderer(mesh, W, H, device="cpu", path="tile",
                                     tri_chunk=1500)
    for r in (single, chunked):
        r.render(u)  # settles the capacities (the retry)
    a, b = single.render_device(u), chunked.render_device(u)
    assert not a[2].any() and not b[2].any()
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())


def _structured_tex_scene(port, **options):
    cfg = port.scene.SceneConfig(
        model_path="structured_scene_tex.obj",
        camera_config=port.scene.CameraConfig.first_person(EYE),
        enable_textures=True, **options)
    return port.scene.Scene.from_config(cfg, 1024, 768)


@pytest.mark.parametrize("row,options,frames", [
    ("tex_textures", {}, 1),
    ("tex_bilinear_ssaa2", {"texture_filter": "bilinear", "ssaa": 2}, 1),
])
def test_structured_tex_golden_frames(port, row, options, frames):
    # The suite's structured_scene_tex rows (36,322 triangles, the tile
    # path) at full size through the CPU twins against the JAX package's
    # frames (scripts/make_torch_ext_golden.py), which chip_smoke.py holds
    # the card's frames against too.
    data = np.load(GOLDEN)
    golden = data[row]
    assert golden.shape[1:] == (768, 1024, 4)
    s = _structured_tex_scene(port, **options)
    assert s.total_tris == 36_322
    assert port.cuda.resolve_path("auto", s.total_tris) == "tile"
    r = port.renderer.Renderer(s.mesh, 1024, 768, device="cpu",
                               **s.renderer_options())
    for i in range(frames):
        assert_frames_match(golden[i], r.render(s.update(DT)))


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [TILE, (8, 8)])
@pytest.mark.parametrize("mode", ["mat", "texf"])
def test_front_modes_on_card(port, small, cuda_device, mode, tile):
    # The kernel against its twin on the same card tensors: meta and
    # coefficients bitwise (NaN positions equal).
    f = _frame(port, small["mesh"])
    before = port.tracing.count("launches.front_end")
    ck, mk = _port_front(port, f, mode, tile, cuda_device)
    assert port.tracing.count("launches.front_end") == before + 1
    cp, mp = _port_front(port, f, mode, tile, cuda_device,
                         fn=port.front.front_end_plain)
    assert port.torch.equal(mk, mp)
    _assert_bitwise_nan(ck.cpu().numpy(), cp.cpu().numpy())


def _port_tables(port, f, mode, tile, device):
    """The port's own chain on the card: the front's table, as the rasters
    take it (no copy), and meta."""
    table, meta = _port_front(port, f, mode, tile, device)
    assert port.raster.kernel_table(table)[0].data_ptr() == table.data_ptr()
    return table, meta


def _assert_kernel_matches_twin(port, mode, out_k, key_k, out_p, key_p):
    t = port.torch
    assert t.equal(key_k.view(t.int32).cpu(), key_p.view(t.int32).cpu())
    covered = key_p.view(t.int32).cpu() != -1
    assert int(covered.sum()) > 2000
    if mode == "texf":  # the planes where the key is set: undefined elsewhere
        defined = port.raster.defined_planes
        assert t.equal(defined(out_k, key_k).cpu().view(t.int32),
                       defined(out_p, key_p).cpu().view(t.int32))
    else:
        gap = (port.raster.unpack_rgba(out_k.view(t.uint32)).int()
               - port.raster.unpack_rgba(out_p.view(t.uint32)).int())
        assert int(gap.abs().max()) <= 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("mode", ["mat", "texf"])
def test_tile_raster_modes_on_card(port, small, cuda_device, mode, layout):
    # Keys bitwise, RGBA within 1 LSB, G-buffer bitwise.
    f = _frame(port, small["mesh"])
    table, meta = _port_tables(port, f, mode, TILE, cuda_device)
    setup = port.binning.setup_from_meta(meta)
    ntx, nty = (W + 255) // 256, (H + 15) // 16
    need = port.binning.exact_tile_counts(setup, ntx, nty)
    binner = (port.binning.bin_triangles_dense if layout == "dense"
              else port.binning.bin_triangles_sort)
    bins = binner(setup, ntx, nty, int(need.sum()), int(need.max()))
    data = bins["bin_rows" if layout == "dense" else "pair_tri"]
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    shading = [dev(a) for a in (f["eff"], f["vpos"], *LIGHTS)]
    kw = dict(height_padded=nty * 16, width_padded=ntx * 256, tile_h=16,
              tile_w=256, layout=layout, mode=mode)
    before = port.tracing.count("launches.raster_shade_tiles")
    out_k, key_k = port.raster.raster_shade_tiles(
        table, data, bins["seg_start"], bins["seg_count"], *shading, **kw)
    assert port.tracing.count("launches.raster_shade_tiles") == before + 1
    params, lights = port.raster.shading_inputs(*shading)
    out_p, key_p = port.raster.raster_shade_tiles_plain(
        table, data, bins["seg_start"], bins["seg_count"], params, lights,
        **kw)
    _assert_kernel_matches_twin(port, mode, out_k, key_k, out_p, key_p)


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["mat", "texf"])
def test_micro_modes_on_card(port, small, cuda_device, mode):
    f = _frame(port, small["mesh"])
    table, meta = _port_tables(port, f, mode, (8, 8), cuda_device)
    ntx, nty = (W + 127) // 128, (H + 7) // 8
    pair_cap = max(int(meta[3].sum()), ntx * nty * 16, 1024)
    bins = port.binning.bin_cells_sort_meta(meta[3], meta[2], meta[0],
                                            meta[1], ntx, nty, pair_cap)
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    shading = [dev(a) for a in (f["eff"], f["vpos"], *LIGHTS)]
    margs = (table, bins["pair_tri"], bins["seg_start"], bins["seg_count"])
    kw = dict(height_padded=nty * 8, width_padded=ntx * 128, mode=mode)
    before = port.tracing.count("launches.raster_shade_micro")
    out_k, key_k = port.micro.raster_shade_micro(
        *margs, bins["tile_count"], *shading, **kw)
    assert port.tracing.count("launches.raster_shade_micro") == before + 1
    params, lights = port.raster.shading_inputs(*shading)
    out_p, key_p = port.micro.raster_shade_micro_plain(
        *margs, params, lights, **kw)
    _assert_kernel_matches_twin(port, mode, out_k, key_k, out_p, key_p)


@pytest.mark.cuda
def test_structured_tex_golden_on_card(port, cuda_device):
    golden = np.load(GOLDEN)["tex_textures"]
    s = _structured_tex_scene(port)
    r = port.renderer.Renderer(s.mesh, 1024, 768, device=cuda_device,
                               **s.renderer_options())
    names = ("launches.front_end", "launches.raster_shade_tiles")
    port.tracing.reset()
    # Tunes the tile shape and settles the capacities: the graphs'
    # captures (an eager warm-up and the capture each) tick the counters.
    r.render(s.update(0.0))
    captured = [port.tracing.count(name) for name in names]
    for name, n in zip(names, captured):
        assert port.tracing.count(name + ".texf") == n >= 2
    for i in range(golden.shape[0]):
        assert_frames_match(golden[i], r.render(s.update(DT)))
    # The frames replay the captured texf graph: no wrapper runs again.
    assert [port.tracing.count(name) for name in names] == captured
