"""The micro (mega-scene) path against the JAX package: cell binning
(``binning.bin_cells_sort_meta``), the micro raster (``micro.py``) and the
whole frame (``cuda.render_frame(path="micro")``, the ``Renderer``'s
calibration, retry and tile->micro fallback), on the meshes and effects
of tests/test_micro.py at 256x192.

- Binning integers are held bitwise: the sorted pair list up to the true
  total, the segments, the tile windows and counts, the needed capacity.
- The micro twin and ``pallas_micro.raster_shade_micro`` (interpret mode)
  get the same numpy table and bins. XLA:CPU contracts mul+add into FMA
  inside the interpret-mode kernel: z = (A + B dx) + C dy moves by up to
  2 ULP, and samples exactly on an edge flip. So at most max(2, H*W/500)
  pixels may differ in coverage, in colour by more than 1 LSB, or in
  depth key by more than 1 ULP.
- Whole frames: the JAX package's CPU front end is compiled XLA, whose
  contracted coefficients move depth by up to ~30 ULP (the cancellation
  in the edge differences amplifies the contraction), so frames are held
  to the pixel budget in coverage and in colour at 2 LSB.

The CUDA kernel is held against the twin only where a card exists."""

import os

import numpy as np
import pytest

from tests.torch_parity import (  # noqa: F401 (fixtures)
    W, H, assert_frames_match, cuda_device, pixel_budget, port, tpu,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_data",
                      "torch_micro_san_miguel_1024x768.npz")
SAN_MIGUEL = "San_Miguel/san-miguel-low-poly.obj"
SAN_MIGUEL_EYE = (13.566635, 2.6288567, 10.243919)
NTX, NTY = (W + 127) // 128, (H + 7) // 8
PAIR_CAP = 65536  # one capacity for every case: one JAX compile
LIGHTS = (np.array([[0.0, 0.0, 5.0], [-5.0, 3.0, 0.0]], np.float32),
          np.array([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5]], np.float32),
          np.array([1.0, 0.5], np.float32))

# (mesh, effect) — tests/test_micro.py:84-125.
CASES = [
    ("icosphere", "none"), ("cube", "none"), ("grid", "none"),
    ("soup", "none"), ("icosphere2", "wave"), ("icosphere2", "edge_melt"),
    ("icosphere2", "voxelize"), ("icosphere2", "mirage"),
]


def _geometry(pkg, name):
    """(positions, normals, (T, 3) int32 indices, eye) from either
    package's procedural module (numpy, identical in both). "soup" is a
    random triangle soup (behind-camera, overlapping) with 20 zero-area
    triangles appended."""
    eye = (0.0, 0.0, 3.0)
    if name == "soup":
        rng = np.random.default_rng(1234)
        n = 120
        pos = rng.uniform(-2, 2, (3 * n, 3)).astype(np.float32)
        pos[:, 2] -= 1.0
        nrm = rng.standard_normal((3 * n, 3)).astype(np.float32)
        tri = np.arange(3 * n, dtype=np.int32).reshape(-1, 3)
        bad = np.stack([tri[:20, 0], tri[:20, 0], tri[:20, 1]], axis=1)
        return pos, nrm, np.concatenate([tri, bad]), eye
    if name == "grid":
        mesh = pkg.procedural.grid_plane(
            48, 48, size=20.0,
            height_fn=lambda x, z: 0.5 * np.sin(x) * np.cos(z))
        eye = (0.0, 2.0, 10.0)
    else:
        mesh = {"icosphere": lambda: pkg.procedural.icosphere(3),
                "icosphere2": lambda: pkg.procedural.icosphere(2),
                "cube": lambda: pkg.procedural.cube(2.0)}[name]()
    tri = mesh.indices.astype(np.int32).reshape(-1, 3)
    return mesh.positions, mesh.normals, tri, eye


def _effect(pkg, name):
    """The effect uniform of tests/test_micro.py's parametrisation."""
    E = pkg.effects.Effect
    make = {
        "wave": lambda: E.wave(0.4, 3.0, 2.0,
                               pkg.effects.WaveDirection.VERTICAL),
        "edge_melt": lambda: E.edge_melt(0.2, 1.0),
        "voxelize": lambda: E.voxelize(0.5, 1.0),
        "mirage": lambda: E.mirage(0.6, 0.7, 0.3),
    }
    if name == "none":
        return np.zeros(6, np.float32)
    effect = make[name]()
    effect.update(0.35)
    return np.asarray(effect.uniform(scene_time=0.35).as_array(), np.float32)


def _case(pkg, name, effect):
    """Numpy frame inputs: positions, normals, tri, view_proj,
    view_position, the lights and the effect."""
    pos, nrm, tri, eye = _geometry(pkg, name)
    u = pkg.camera.Camera.first_person(list(eye), aspect=W / H).uniform()
    return {"pos": np.asarray(pos, np.float32),
            "nrm": np.asarray(nrm, np.float32), "tri": tri,
            "vp": np.asarray(u.view_proj, np.float32),
            "vpos": np.asarray(u.view_position, np.float32),
            "lights": LIGHTS, "eff": _effect(pkg, effect)}


def _frame_tensors(port, c, device="cpu"):
    """The port's render_frame arguments from a case."""
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a)).to(device)
    return (dev(c["pos"]), dev(c["nrm"]), dev(c["tri"]), dev(c["vp"]),
            dev(c["vpos"]), *[dev(a) for a in c["lights"]], dev(c["eff"]))


def _jax_stage(tpu, c, pair_cap=PAIR_CAP, use_pallas_expand=False):
    """The JAX package's CPU chain of render_frame_micro (vertex stage,
    setup at (8, 8), table columns, cell binning) as numpy."""
    jnp = tpu.jnp
    tri = jnp.asarray(c["tri"])
    pos_soa = jnp.asarray(c["pos"])[tri].transpose(1, 2, 0)
    nrm_soa = jnp.asarray(c["nrm"])[tri].transpose(1, 2, 0)
    vp, eff = jnp.asarray(c["vp"]), jnp.asarray(c["eff"])
    world, screen = tpu.common.vertex_stage_soa(pos_soa, vp, eff, W, H)
    setup = tpu.common.triangle_setup_soa(screen, eff, W, H, 8, 8)
    nrm = tuple(tuple(nrm_soa[k, ch] for ch in range(3)) for k in range(3))
    table = jnp.stack(tpu.pallas_raster.tri_table_columns(screen, nrm, world),
                      axis=1)
    rx, _, cnt = tpu.binning.cover_counts(setup)
    meta = np.stack([np.asarray(setup["tile_x0"]),
                     np.asarray(setup["tile_y0"]), np.asarray(rx),
                     np.asarray(cnt)]).astype(np.int32)
    bins = tpu.binning.bin_cells_sort(setup, NTX, NTY, pair_cap,
                                      interpret=True,
                                      use_pallas_expand=use_pallas_expand)
    return np.array(table), meta, {
        k: np.array(v) for k, v in bins.items() if k != "layout"}


INTS = ("seg_start", "seg_count", "win_start", "tile_count", "total_pairs",
        "pair_needed")


@pytest.mark.parametrize("expand", ["xla", "pallas"])
@pytest.mark.parametrize("name,effect,pair_cap", [
    ("icosphere", "none", PAIR_CAP), ("grid", "none", PAIR_CAP),
    ("icosphere2", "voxelize", PAIR_CAP), ("soup", "none", PAIR_CAP),
    ("icosphere", "none", 256),  # overflow: the exact need is reported
])
def test_bin_cells_sort_meta_bitwise(port, tpu, name, effect, pair_cap,
                                     expand):
    c = _case(tpu, name, effect)
    _, meta, a = _jax_stage(tpu, c, pair_cap, expand == "pallas")
    t = port.torch
    b = port.binning.bin_cells_sort_meta(
        *[t.from_numpy(meta[i]) for i in (3, 2, 0, 1)], NTX, NTY, pair_cap)
    assert b["layout"] == "micro"
    for k in INTS:
        np.testing.assert_array_equal(a[k], b[k].numpy(), err_msg=k)
    n = min(int(a["total_pairs"]), pair_cap)
    np.testing.assert_array_equal(a["pair_tri"][:n],
                                  b["pair_tri"].numpy()[:n])
    assert int(b["tile_needed"]) == 0
    assert (int(b["pair_needed"]) > 0) == (pair_cap == 256)
    # bin_cells_sort (from a setup dict) is the same binning.
    setup = port.binning.setup_from_meta(t.from_numpy(meta))
    d = port.binning.bin_cells_sort(setup, NTX, NTY, pair_cap)
    for k in INTS:
        assert t.equal(d[k], b[k]), k


def _jax_micro(tpu, table, bins, c):
    jnp = tpu.jnp
    coeffs = tpu.pallas_micro.build_pair_coeffs(jnp.asarray(table),
                                                jnp.asarray(bins["pair_tri"]))
    rgba, key = tpu.pallas_micro.raster_shade_micro(
        coeffs, *[jnp.asarray(bins[k]) for k in ("seg_start", "seg_count",
                                                 "win_start", "tile_count")],
        jnp.asarray(c["eff"]), jnp.asarray(c["vpos"]),
        *[jnp.asarray(a) for a in c["lights"]], height_padded=NTY * 8,
        width_padded=NTX * 128, interpret=True)
    return np.asarray(rgba), np.asarray(key)


def _port_micro(port, table, bins, c):
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a))
    rgba, key = port.micro.raster_shade_micro(
        dev(table), *[dev(bins[k]) for k in ("pair_tri", "seg_start",
                                             "seg_count", "tile_count")],
        dev(c["eff"]), dev(c["vpos"]), *[dev(a) for a in c["lights"]],
        height_padded=NTY * 8, width_padded=NTX * 128)
    assert rgba.dtype == t.uint32 and key.dtype == t.uint32
    return rgba.numpy(), key.numpy()


def _unpack(packed):
    return packed.view(np.uint8).reshape(*packed.shape, 4)


def _assert_keys_close(ka, kb, ulp=None):
    """Coverage (key != clear) differs on at most the pixel budget, and,
    with ``ulp``, so do keys further apart than ``ulp`` where both
    cover."""
    budget = pixel_budget(*ka.shape)
    ka, kb = ka.astype(np.int64), kb.astype(np.int64)
    ca, cb = ka != 0xFFFFFFFF, kb != 0xFFFFFFFF
    assert int((ca != cb).sum()) <= budget
    if ulp is not None:
        far = ca & cb & (np.abs(ka - kb) > ulp)
        assert int(far.sum()) <= budget
    assert cb.any()


@pytest.mark.parametrize("name,effect", CASES)
def test_twin_vs_pallas_micro(port, tpu, name, effect):
    c = _case(tpu, name, effect)
    table, _, bins = _jax_stage(tpu, c)
    assert not int(bins["pair_needed"])
    ra, ka = _jax_micro(tpu, table, bins, c)
    rb, kb = _port_micro(port, table, bins, c)
    assert rb.shape == ra.shape == (NTY * 8, NTX * 128)
    assert_frames_match(_unpack(ra), _unpack(rb), lsb=1)
    _assert_keys_close(ka, kb, ulp=1)
    assert (rb[kb == 0xFFFFFFFF] == 0xFFFF0000).all()


@pytest.mark.parametrize("name,effect", CASES)
def test_render_frame_micro_vs_jax(port, tpu, name, effect):
    c = _case(tpu, name, effect)
    jnp = tpu.jnp
    ra, ka, oa = tpu.backend.render_frame_micro(
        jnp.asarray(c["pos"]), jnp.asarray(c["nrm"]),
        jnp.zeros((c["pos"].shape[0], 2), jnp.float32),
        jnp.asarray(c["tri"]), jnp.asarray(c["vp"]), jnp.asarray(c["vpos"]),
        *[jnp.asarray(a) for a in c["lights"]], jnp.asarray(c["eff"]),
        width=W, height=H, pair_cap=PAIR_CAP, interpret=True)
    rb, kb, ob = port.cuda.render_frame(*_frame_tensors(port, c), width=W,
                                        height=H, pair_cap=PAIR_CAP,
                                        path="micro")
    assert rb.shape == (H, W, 4) and rb.dtype == port.torch.uint8
    assert kb.dtype == port.torch.uint32
    np.testing.assert_array_equal(np.asarray(oa), ob.numpy())
    assert not ob.numpy().any()
    assert_frames_match(np.asarray(ra), rb.numpy())
    _assert_keys_close(np.asarray(ka), kb.numpy())


def test_calibration_and_overflow_retry(port, tpu):
    c = _case(tpu, "grid", "none")
    mesh = port.convert.mesh_from_arrays(
        c["pos"], c["nrm"], np.zeros((c["pos"].shape[0], 2), np.float32),
        c["tri"].reshape(-1))
    uniforms = port.convert.uniforms_from_arrays(
        c["vpos"], c["vp"], *c["lights"], c["eff"])
    # Calibration: the first checked frame settles pair_cap to the exact
    # need (+12.5%) that the JAX engine's _count_pairs measures.
    r = port.renderer.Renderer(mesh, W, H, device="cpu", path="micro")
    img = r.render(uniforms)
    packed, _ = tpu.renderer.Renderer.pack_uniforms(uniforms)
    tri = tpu.jnp.asarray(c["tri"])
    pos_soa = tpu.jnp.asarray(c["pos"])[tri].transpose(1, 2, 0)
    need = int(tpu.renderer._count_pairs(tpu.jnp.asarray(packed), pos_soa,
                                         w=W, h=H))
    num_cells = NTX * NTY * 16
    assert r.options["pair_cap"] == tpu.backend.grow_pair_cap(
        0, max(need, num_cells, 1024))
    # Overflow: a tiny pinned pair_cap reports the exact need, the retry
    # grows to it (no calibration: the caller pinned the cap), and the
    # frame is the calibrated one.
    _, _, ovf = port.cuda.render_frame(*_frame_tensors(port, c), width=W,
                                       height=H, pair_cap=256, path="micro")
    assert ovf.tolist() == [need, 0]
    small = port.renderer.Renderer(mesh, W, H, device="cpu", path="micro",
                                   pair_cap=256)
    np.testing.assert_array_equal(small.render(uniforms), img)
    assert small.options["pair_cap"] == tpu.backend.grow_pair_cap(256, need)
    host = port.cuda.render(mesh, port.camera.Camera.first_person(
        [0.0, 2.0, 10.0], aspect=W / H).uniform(), c["lights"], c["eff"],
        W, H, device="cpu", path="micro", pair_cap=256)
    np.testing.assert_array_equal(host, img)
    assert port.cuda.default_caps("micro", mesh.num_triangles, W, H) == \
        tpu.backend.default_caps("micro", mesh.num_triangles, W, H)
    assert port.binning.default_pair_cap_micro(10**6, num_cells) == \
        tpu.binning.default_pair_cap_micro(10**6, num_cells)


def _stacked(port, n):
    """n coincident triangles in one 16x256 tile."""
    base = port.procedural.single_triangle(z=0.0)
    pos = np.tile(base.positions, (n, 1)) * np.float32(0.1)
    pos[:, 2] += np.repeat(np.linspace(0, 0.5, n), 3).astype(np.float32)
    return port.convert.mesh_from_arrays(
        pos, np.tile(base.normals, (n, 1)), np.tile(base.uvs, (n, 1)),
        np.arange(3 * n, dtype=np.uint32))


def test_tile_to_micro_fallback(port):
    # 9,000 triangles in one tile outgrow MAX_TILE_CAP (8,192): "auto"
    # falls back to the micro path and re-calibrates its pair capacity.
    W2, H2 = 128, 96
    mesh = _stacked(port, 9000)
    u = port.camera.Camera.first_person([0, 0, 3.0], aspect=W2 / H2).uniform()
    uniforms = port.convert.uniforms_from_arrays(
        u.view_position, u.view_proj, [[0.0, 0.0, 5.0]], [[1.0, 0.9, 0.8]],
        [1.0], [0, 0, 0, 0, 0, 0])
    r = port.renderer.Renderer(mesh, W2, H2, device="cpu")
    img = r.render(uniforms)
    assert r.options["path"] == "micro" and "tile_cap" not in r.options
    ref = port.renderer.Renderer(mesh, W2, H2, device="cpu", path="micro")
    np.testing.assert_array_equal(img, ref.render(uniforms))
    assert r.options["pair_cap"] == ref.options["pair_cap"]
    assert (img[..., 0] > 0).any()
    with pytest.raises(RuntimeError, match="MAX_TILE_CAP"):
        port.renderer.Renderer(mesh, W2, H2, device="cpu",
                               path="tile").render(uniforms)


def _san_miguel(port, width=1024, height=768):
    cc = port.scene.CameraConfig(mode=port.camera.CameraMode.FIRST_PERSON,
                                 position=SAN_MIGUEL_EYE)
    return port.scene.Scene.from_config(
        port.scene.SceneConfig(model_path=SAN_MIGUEL, camera_config=cc),
        width, height)


def test_san_miguel_golden_frames(port):
    # The full-width configuration: 998,784 triangles at 1024x768 resolve
    # to the micro path; three frames against the JAX package's
    # (scripts/make_torch_micro_golden.py), which chip_smoke.py holds the
    # card's frames against.
    golden = np.load(GOLDEN)["rgba"]
    assert golden.shape == (3, 768, 1024, 4)
    s = _san_miguel(port)
    assert s.total_tris == 998_784
    assert port.cuda.resolve_path("auto", s.total_tris) == "micro"
    r = port.renderer.Renderer(s.mesh, 1024, 768, device="cpu",
                               **s.renderer_options())
    for i in range(3):
        img = r.render(s.update(1.0 / 60.0))
        assert_frames_match(golden[i], img)
    assert r.options["pair_cap"] < port.cuda.default_caps(
        "micro", s.total_tris, 1024, 768)["pair_cap"]


def test_unported_micro_modes_raise(port):
    # The mode is an argument, and the table must have its width: the
    # 46-wide table is texf_mip's, a width that is no mode's is refused.
    t = port.torch
    z = t.zeros((NTX * NTY * 16,), dtype=t.int32)
    args = (t.zeros((8,), dtype=t.int32), z, z,
            t.zeros((NTX * NTY,), dtype=t.int32), t.zeros(6), t.zeros(4),
            t.zeros((1, 3)), t.zeros((1, 3)), t.zeros(1))
    kw = dict(height_padded=NTY * 8, width_padded=NTX * 128)
    with pytest.raises(ValueError, match="46"):
        port.micro.raster_shade_micro(t.zeros((4, 46)), *args, **kw)
    with pytest.raises(ValueError, match="44"):
        port.micro.raster_shade_micro(t.zeros((4, 36)), *args, **kw)
    for mode, width in (("texf_mip", 46), ("vis", 32)):
        out, key = port.micro.raster_shade_micro(t.zeros((4, width)), *args,
                                                 mode=mode, **kw)
        assert key.dtype == t.uint32 and not (key != 0xFFFFFFFF).any()
    assert (out == port.raster.PAIR_IDX_CLEAR).all()  # vis, nothing binned


# The culled walk's cases: chip_smoke.py's stress inputs (samples exactly on
# edges, -0.0 depth planes, NaN and infinite rows, duplicates whose equal
# keys straddle spans, mirage) in every mode, and the port's own chain
# under each effect, on a stripe's rows, in base and vis mode; cells split
# at a span of 4.
CULLED_MODES = ("base", "mat", "texf", "vis", "texf_mip")
CULLED_CASES = [
    ("stress", "edges"), ("stress", "nan_zero"), ("stress", "duplicates"),
    ("stress", "edges+mirage"), ("chain", "none"), ("chain", "mirage"),
    ("chain", "voxelize"), ("chain", "edge_melt"), ("chain", "stripe"),
    ("chain", "vis"),
]


def _culled_inputs(port, source, kind):
    """[(mode, args, kw)] of the micro twin for a case of CULLED_CASES."""
    from tests import test_torch_walks as walks

    if source == "stress":
        smoke = walks._smoke()
        x = smoke.stress_inputs(kind, "cpu", 4)
        assert x["densest"] > 4  # cells split at a span of 4
        kw = dict(height_padded=smoke.STRESS_H, width_padded=smoke.STRESS_W)
        return [(mode, (x["tables"][mode], *x["micro"][:3], x["params"],
                        x["light_rows"]), kw) for mode in CULLED_MODES]
    effect = kind if kind in walks.EFFECTS else "none"
    base, bins, params, lights, (hp, wp) = walks._port_chain(port, effect,
                                                             (8, 8))
    assert int(bins["seg_count"].max()) > 4
    if kind == "stripe":  # a stripe's rows: sample y at global row + 8
        params = params.clone()
        params[7] = 8.0
    mode = "vis" if kind == "vis" else "base"
    return [(mode, (base, bins["pair_tri"], bins["seg_start"],
                    bins["seg_count"], params, lights),
             dict(height_padded=hp, width_padded=wp))]


@pytest.mark.parametrize("source,kind", CULLED_CASES)
def test_culled_walk_equals_micro_twin(port, source, kind):
    # The kernel's walk, culled to 2x2 quads, equals the twin bitwise (keys,
    # RGBA, G-buffers, vis pair ids), at the kernel's span and at a span of
    # 4; the samples its walk tested are the twin's fold of them
    # (samples_tested_plain), 4 a kept quad and 64 a pair walked whole.
    from tests import test_torch_walks as walks

    for mode, args, kw in _culled_inputs(port, source, kind):
        plain = port.micro.raster_shade_micro_plain(*args, mode=mode, **kw)
        assert int((plain[1] != -1).sum()) > 0
        fold = port.micro.samples_tested_plain(
            args[0], *args[1:5], width_padded=kw["width_padded"])
        for span in (4, port.micro.SPAN):
            stats = {}
            culled = port.micro.raster_shade_micro_culled_plain(
                *args, mode=mode, stats=stats, span=span, **kw)
            assert walks._equal(port, culled, plain), (mode, span)
            assert int(fold) == stats["samples"] > 0
            assert (4 * stats["items"] <= stats["samples"]
                    <= 4 * stats["items"] + 64 * stats["wide"])
            assert stats["samples"] < 64 * stats["pairs"]


@pytest.mark.cuda
@pytest.mark.parametrize("name,effect", CASES)
def test_kernels_vs_twins_on_card(port, cuda_device, name, effect):
    # The front end at (8, 8), the expansion and the micro raster, each
    # against its twin on the same card tensors (so that sinf is the
    # card's on both sides): meta and coefficients bitwise (<= 1 ULP on
    # the wave frame), pairs bitwise, keys bitwise, RGBA within 1 LSB.
    t = port.torch
    c = _case(port, name, effect)
    pos, nrm, tri, vp, vpos, lwp, lc, li, eff = _frame_tensors(
        port, c, cuda_device)
    args = (port.cuda.corner_soa(pos, tri), port.cuda.corner_soa(nrm, tri),
            vp, eff)
    kw = dict(width=W, height=H, tile_h=8, tile_w=8)
    before = (port.tracing.count("launches.front_end"),
              port.tracing.count("launches.expand_cells"),
              port.tracing.count("launches.raster_shade_micro"))
    ck, mk = port.front.front_end(*args, **kw)
    cp, mp = port.front.front_end_plain(*args, **kw)
    assert t.equal(mk, mp)
    assert t.equal(t.isnan(ck), t.isnan(cp))
    keep = ~t.isnan(ck)
    gap = (ck[keep].view(t.int32).long() - cp[keep].view(t.int32).long())
    assert int(gap.abs().max()) <= (1 if effect == "wave" else 0)

    meta = (mk[3], mk[2], mk[0], mk[1])
    ekw = dict(pair_cap=PAIR_CAP, ntx_t=NTX, num_cells=NTX * NTY * 16)
    cell_k, tri_k, total_k = port.expand.expand_cells(*meta, **ekw)
    cell_p, tri_p, total_p = port.expand.expand_cells_plain(*meta, **ekw)
    n = int(total_p)
    assert int(total_k) == n
    assert t.equal(cell_k[:n], cell_p[:n]) and t.equal(tri_k[:n], tri_p[:n])

    bins = port.binning.bin_cells_sort_meta(*meta, NTX, NTY, PAIR_CAP)
    bins_cpu = port.binning.bin_cells_sort_meta(*[m.cpu() for m in meta],
                                                NTX, NTY, PAIR_CAP)
    for k in INTS:
        assert t.equal(bins[k].cpu(), bins_cpu[k]), k
    assert t.equal(bins["pair_tri"][:n].cpu(), bins_cpu["pair_tri"][:n])
    margs = (ck, bins["pair_tri"], bins["seg_start"],
             bins["seg_count"])
    mkw = dict(height_padded=NTY * 8, width_padded=NTX * 128)
    rk, kk = port.micro.raster_shade_micro(*margs, bins["tile_count"], eff,
                                           vpos, lwp, lc, li, **mkw)
    params, lights = port.raster.shading_inputs(eff, vpos, lwp, lc, li)
    rp, kp = port.micro.raster_shade_micro_plain(*margs, params, lights,
                                                 **mkw)
    # The card's bin_cells_sort_meta launched the expansion a second time.
    assert (port.tracing.count("launches.front_end"),
            port.tracing.count("launches.expand_cells"),
            port.tracing.count("launches.raster_shade_micro")) == (
                before[0] + 1, before[1] + 2, before[2] + 1)
    assert t.equal(kk.view(t.int32), kp)
    gap = (port.raster.unpack_rgba(rk).int()
           - port.raster.unpack_rgba(rp.view(t.uint32)).int())
    assert int(gap.abs().max()) <= 1
    assert int((kp != -1).sum()) > 0


@pytest.mark.cuda
def test_san_miguel_on_card(port, cuda_device):
    golden = np.load(GOLDEN)["rgba"]
    s = _san_miguel(port)
    r = port.renderer.Renderer(s.mesh, 1024, 768, device=cuda_device,
                               **s.renderer_options())
    port.tracing.reset()
    for i in range(3):
        assert_frames_match(golden[i], r.render(s.update(1.0 / 60.0)))
    # One calibration front launch, then one capture of the frame (an
    # eager warm-up and the capture tick the counters); the three frames
    # replay it.
    assert port.tracing.count("launches.front_end") == 3
    assert port.tracing.count("launches.expand_cells") == 2
    assert port.tracing.count("launches.raster_shade_micro") == 2
    assert port.tracing.count("launches.raster_shade_tiles") == 0
