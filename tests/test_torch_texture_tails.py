"""The texture stages of ``backends/texture.py`` (the fused tails, the
deferred tail and the per-frame mip rows) against the JAX package, on the
small structured build of tests/test_torch_ext.py (5,362 triangles, two
lights) at 256x192, first person at (13.566635, 4.0, 24.0).

Each wrapper's CPU path (its plain version) takes the same numpy inputs as
the JAX package, run op by op (``jax.disable_jit()``). Tolerances:

- ``texture_tail`` (nearest, bilinear; the f32 and the u8-packed pool)
  and ``texture_tail_mip`` (trilinear, anisotropic) on the same
  G-buffer: bitwise;
- ``mip_rows`` from the positions against JAX ``mip_tri_rows(
  uv_gradients(vertex_stage(...)))``: tid, mu and mv bitwise, lod within
  ``LOD_ULPS`` and the spread within ``SPREAD_ULPS`` (XLA:CPU's log2 and
  1/x are not torch's; tests/test_torch_mip.py), padding rows included;
- ``deferred_tail`` against JAX ``textured_shade(resolve_attributes(...))``
  (tile path) and ``tpu.micro_vis_tail`` (micro path): bitwise under
  nearest and bilinear, and within 1 LSB under the mip filters (their
  lod), which is inside tests/torch_parity.py's pixel contract; with and
  without mirage, and on a stripe's window (pixel offsets).

The ``cuda``-marked tests hold each kernel to its plain version on the
card and skip here.
"""

import numpy as np
import pytest

from tests.test_torch_ext import (  # noqa: F401 (fixtures and constants)
    LIGHTS, _gbuffer, small,
)
from tests.test_torch_mip import (  # noqa: F401 (fixtures and helpers)
    MIP_FILTERS, _mip_gbuffer, assert_bitwise_nan, assert_rows_match, frame,
    port_frame, ulps,
)
from tests.test_torch_vis import EFFECTS, _tex_inputs, _winners
from tests.torch_parity import (  # noqa: F401 (fixtures)
    W, H, assert_frames_match, cuda_device, port, tpu,
)

FLAT_FILTERS = ["nearest", "bilinear"]
FILTERS = FLAT_FILTERS + MIP_FILTERS
# (x_offset, y_offset, width, height) of the deferred tail's window: the
# whole frame, or a stripe's window of it.
WINDOWS = {"frame": (0, 0, W, H), "stripe": (16, 96, W - 16, H - 96)}
PAIR_IDX_CLEAR = 2**31 - 1  # raster.PAIR_IDX_CLEAR


@pytest.fixture(scope="module")
def texture(port):
    from compute_renderer_torch.backends import texture

    return texture


def _nan_gbuffer(rng, g, key, base):
    """``g`` with NaN uv where no textured winner is (uncovered pixels,
    untextured faces) and uv past 1 elsewhere: the masks must hold."""
    g = g.copy()
    untextured = (key == 0xFFFFFFFF) | (
        g[6] <= 0 if base == 8 else g[5] < 0)
    g[0:2, untextured] = np.nan
    wide = rng.random(key.shape) < 0.3
    g[0:2, wide & ~untextured] *= 7.0
    return g


@pytest.mark.parametrize("pool", ["f32", "packed"])
@pytest.mark.parametrize("tex_filter", FLAT_FILTERS)
def test_texture_tail_vs_jax(port, tpu, small, texture, tex_filter, pool):
    from compute_renderer_torch.io.textures import pack_pool_u8

    mesh = small["mesh"]
    rng = np.random.default_rng(21)
    g, key = _gbuffer(rng, 48, 64, 2, mesh.tex_table)
    g = _nan_gbuffer(rng, g, key, 8)
    packed = pack_pool_u8(mesh.texels) if pool == "packed" else None
    assert pool == "f32" or packed is not None
    jnp, t = tpu.jnp, port.torch
    with tpu.jax.disable_jit():
        a = tpu.common.fused_texture_tail(
            jnp.asarray(g), jnp.asarray(key), jnp.asarray(mesh.texels),
            jnp.asarray(LIGHTS[1]), jnp.asarray(LIGHTS[2]),
            tex_filter=tex_filter,
            texels_packed=None if packed is None else jnp.asarray(packed))
    before = port.tracing.count("launches.texture_tail")
    b = texture.texture_tail(
        t.from_numpy(g), t.from_numpy(key.view(np.int32)).view(t.uint32),
        t.from_numpy(mesh.texels), t.from_numpy(LIGHTS[1]),
        t.from_numpy(LIGHTS[2]), tex_filter=tex_filter,
        texels_packed=None if packed is None else t.from_numpy(packed))
    assert port.tracing.count("launches.texture_tail") == before  # the CPU: no kernel
    assert b.dtype == t.uint8 and b.shape == (48, 64, 4)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert (b.numpy()[key == 0xFFFFFFFF] == [0, 0, 255, 255]).all()


@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_texture_tail_mip_vs_jax(port, tpu, frame, texture, tex_filter):
    rng = np.random.default_rng(22)
    g, key = _mip_gbuffer(rng, 48, 64, 2, frame["mips"])
    g = _nan_gbuffer(rng, g, key, 10)
    jnp, t = tpu.jnp, port.torch
    with tpu.jax.disable_jit():
        a = tpu.common.fused_texture_tail_mip(
            jnp.asarray(g), jnp.asarray(key), jnp.asarray(frame["pool"]),
            jnp.asarray(frame["mips"]), jnp.asarray(LIGHTS[1]),
            jnp.asarray(LIGHTS[2]), tex_filter=tex_filter)
    b = texture.texture_tail_mip(
        t.from_numpy(g), t.from_numpy(key.view(np.int32)).view(t.uint32),
        t.from_numpy(frame["pool"]), t.from_numpy(frame["mips"]),
        t.from_numpy(LIGHTS[1]), t.from_numpy(LIGHTS[2]),
        tex_filter=tex_filter)
    assert b.dtype == t.uint8 and b.shape == (48, 64, 4)
    np.testing.assert_array_equal(np.asarray(a), b.numpy())


def _padded(f, pad=7):
    """The frame's triangles plus ``pad`` (0, 0, 0) padding rows with
    face_tex -1, as a sort-middle slice hands them in."""
    tri = np.concatenate([f["tri"], np.zeros((pad, 3), np.int32)])
    face_tex = np.concatenate([f["mesh"].face_tex,
                               np.full(pad, -1, np.int32)])
    return tri, face_tex


@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_mip_rows_vs_jax(port, tpu, frame, texture, tex_filter):
    f = frame
    mesh = f["mesh"]
    tri, face_tex = _padded(f)
    jnp, t = tpu.jnp, port.torch
    with tpu.jax.disable_jit():
        _, screen = tpu.common.vertex_stage(
            jnp.asarray(mesh.positions), jnp.asarray(f["vp"]),
            jnp.asarray(f["eff"]), W, H)
        guv = tpu.common.uv_gradients(jnp.asarray(tri), screen,
                                      jnp.asarray(mesh.uvs))
        theirs = np.asarray(tpu.common.mip_tri_rows(
            jnp.asarray(face_tex), jnp.asarray(f["mips"]), guv, tex_filter))
    ours = texture.mip_rows(
        t.from_numpy(mesh.positions), t.from_numpy(tri),
        t.from_numpy(mesh.uvs), t.from_numpy(face_tex),
        t.from_numpy(f["mips"]), t.from_numpy(f["vp"]),
        t.from_numpy(f["eff"]), W, H, tex_filter).numpy()
    assert ours.shape == (tri.shape[0], 5) and ours.dtype == np.float32
    assert_rows_match(theirs, ours)
    pad = ours[-7:]
    assert (pad[:, 0] == -1).all() and (pad[:, 1] == 0).all()
    assert not pad[:, 2:].any()


def _deferred_jax(tpu, f, best, effect, tex_filter, window):
    x_off, y_off, w, h = window
    texels, table, mips = _tex_inputs(f, tex_filter)
    mesh = f["mesh"]
    mip = mips is not None
    jnp = tpu.jnp
    with tpu.jax.disable_jit():
        g = tpu.common.resolve_attributes(
            jnp.asarray(best), jnp.asarray(f["tri"]),
            jnp.asarray(f["screen"]), jnp.asarray(f["world"]),
            jnp.asarray(mesh.normals), jnp.asarray(mesh.uvs),
            jnp.asarray(EFFECTS[effect]), w, h, x_off, y_off)
        return np.asarray(tpu.common.textured_shade(
            g, jnp.asarray(best), jnp.asarray(mesh.face_kd),
            jnp.asarray(mesh.face_tex), jnp.asarray(texels),
            jnp.asarray(table), jnp.asarray(f["vpos"]),
            *[jnp.asarray(x) for x in LIGHTS], tex_filter=tex_filter,
            tex_mips=jnp.asarray(mips) if mip else None,
            guv=jnp.asarray(f["guv"]) if mip else None))


def _port_rows(port, texture, f, tex_filter):
    t = port.torch
    mesh = f["mesh"]
    if tex_filter not in MIP_FILTERS:
        return None
    return texture.mip_rows(
        t.from_numpy(mesh.positions), t.from_numpy(f["tri"]),
        t.from_numpy(mesh.uvs), t.from_numpy(mesh.face_tex),
        t.from_numpy(f["mips"]), t.from_numpy(f["vp"]),
        t.from_numpy(f["eff"]), W, H, tex_filter)


def _deferred_port(port, texture, f, ids, key, effect, tex_filter, window,
                   pair_tri=None, device="cpu", fn=None):
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a)).to(device)
    mesh = f["mesh"]
    texels, table, mips = _tex_inputs(f, tex_filter)
    rows = _port_rows(port, texture, f, tex_filter)
    fn = fn or texture.deferred_tail
    return fn(
        dev(ids), dev(key.view(np.int32)), dev(f["tri"]), dev(f["screen"]),
        dev(f["world"]), dev(mesh.normals), dev(mesh.uvs),
        dev(EFFECTS[effect]), dev(mesh.face_kd), dev(mesh.face_tex),
        dev(texels), dev(table), dev(f["vpos"]), *[dev(x) for x in LIGHTS],
        tex_filter=tex_filter, tex_mips=None if mips is None else dev(mips),
        rows=None if rows is None else rows.to(device),
        pair_tri=None if pair_tri is None else dev(pair_tri),
        x_offset=window[0], y_offset=window[1])


def _assert_deferred(a, b, tex_filter):
    assert b.dtype == np.uint8 and b.shape == a.shape
    if tex_filter in MIP_FILTERS:
        assert int(np.abs(a.astype(int) - b.astype(int)).max()) <= 1
    else:
        np.testing.assert_array_equal(a, b)
    assert_frames_match(a, b)


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("effect", ["none", "mirage"])
@pytest.mark.parametrize("tex_filter", FILTERS)
def test_deferred_tail_tile_vs_jax(port, tpu, frame, texture, tex_filter,
                                   effect, window):
    win = WINDOWS[window]
    best = _winners(frame, 8)[:win[3], :win[2]]
    a = _deferred_jax(tpu, frame, best, effect, tex_filter, win)
    key = np.where(best >= 0, 7, 0xFFFFFFFF).astype(np.uint32)
    b = _deferred_port(port, texture, frame, best, key, effect, tex_filter,
                       win).numpy()
    _assert_deferred(a, b, tex_filter)
    assert (b[best < 0] == [0, 0, 255, 255]).all()
    assert (b[best >= 0] != [0, 0, 255, 255]).any(axis=-1).sum() > 10000


def _pairs(frame, seed=9):
    """A micro raster's vis output: a sorted pair list over the frame's
    live triangles, each pixel's winning pair index (PAIR_IDX_CLEAR and
    a cleared key where uncovered) and its key."""
    rng = np.random.default_rng(seed)
    best = _winners(frame, seed)
    live = np.unique(best[best >= 0])
    pair_tri = np.sort(rng.choice(live, 6000)).astype(np.int32)
    ids = rng.integers(0, pair_tri.shape[0], (H, W)).astype(np.int32)
    key = rng.integers(0, 2**31, (H, W)).astype(np.uint32)
    clear = rng.random((H, W)) < 0.2
    key[clear] = 0xFFFFFFFF
    ids[clear] = PAIR_IDX_CLEAR
    return pair_tri, ids, key


@pytest.mark.parametrize("window", list(WINDOWS))
@pytest.mark.parametrize("effect", ["none", "mirage"])
@pytest.mark.parametrize("tex_filter", FILTERS)
def test_deferred_tail_micro_vs_jax(port, tpu, frame, texture, tex_filter,
                                    effect, window):
    # tpu.micro_vis_tail: the pair -> triangle map, then the resolve over
    # the 3T virtual corner vertices (the floats the per-vertex arrays
    # give through tri), the atlas and the shading.
    f = frame
    x_off, y_off, w, h = WINDOWS[window]
    pair_tri, ids, key = _pairs(f)
    ids, key = ids[:h, :w], key[:h, :w]
    mesh, tri = f["mesh"], f["tri"]
    texels, table, mips = _tex_inputs(f, tex_filter)
    jnp = tpu.jnp
    with tpu.jax.disable_jit():
        pos_soa = jnp.asarray(mesh.positions[tri].transpose(1, 2, 0))
        world_soa, screen_soa = tpu.common.vertex_stage_soa(
            pos_soa, jnp.asarray(f["vp"]), jnp.asarray(f["eff"]), W, H)
        nrm = mesh.normals[tri].transpose(1, 2, 0)
        nrm_tuples = tuple(tuple(jnp.asarray(nrm[k, c]) for c in range(3))
                           for k in range(3))
        a = np.asarray(tpu.backend.micro_vis_tail(
            jnp.asarray(ids), jnp.asarray(key), jnp.asarray(pair_tri),
            screen_soa, world_soa, nrm_tuples, jnp.asarray(mesh.uvs[tri]),
            jnp.asarray(EFFECTS[effect]), w, h, jnp.asarray(mesh.face_kd),
            jnp.asarray(mesh.face_tex), jnp.asarray(texels),
            jnp.asarray(table), jnp.asarray(f["vpos"]),
            *[jnp.asarray(x) for x in LIGHTS], x_offset=x_off,
            y_offset=y_off, tex_filter=tex_filter,
            tex_mips=None if mips is None else jnp.asarray(mips)))
    b = _deferred_port(port, texture, f, ids, key, effect, tex_filter,
                       WINDOWS[window], pair_tri=pair_tri).numpy()
    _assert_deferred(a, b, tex_filter)
    assert (b[key == 0xFFFFFFFF] == [0, 0, 255, 255]).all()


def test_wrappers_refuse_other_devices_and_filters(port, texture):
    t = port.torch
    meta = lambda *s, dtype=t.float32: t.empty(s, dtype=dtype,
                                               device="meta")
    lights = (meta(2, 3), meta(2))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        texture.texture_tail(meta(12, 4, 4), meta(4, 4, dtype=t.int32),
                             meta(8, 3), *lights)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        texture.mip_rows(meta(3, 3), meta(1, 3, dtype=t.int32), meta(3, 2),
                         meta(1, dtype=t.int32), meta(1, 1, 3,
                                                      dtype=t.int32),
                         meta(4, 4), meta(6), 8, 8, "trilinear")
    cpu = t.zeros((12, 4, 4))
    with pytest.raises(ValueError, match="not 'trilinear'"):
        texture.texture_tail(cpu, t.zeros((4, 4), dtype=t.int32),
                             t.zeros((8, 3)), t.zeros((2, 3)), t.zeros(2),
                             tex_filter="trilinear")
    with pytest.raises(ValueError, match="needs the mip pool"):
        texture.deferred_tail(*([None] * 16), tex_filter="anisotropic")


def _textured_scenes(port, small, tex_filter):
    cfg = port.scene.SceneConfig(
        model_path=str(small["path"]),
        camera_config=port.scene.CameraConfig.first_person(
            (13.566635, 4.0, 24.0)),
        enable_textures=True, texture_filter=tex_filter)
    return port.scene.Scene.from_config(cfg, 128, 96)


# (tex_filter, tex_mode, path, the wrappers a frame calls)
ENGINE_CASES = [
    ("bilinear", "fused", "tile", {"texture_tail"}),
    ("trilinear", "fused", "micro", {"texture_tail_mip", "mip_rows"}),
    ("anisotropic", "deferred", "tile",
     {"deferred_tail", "mip_rows", "vertex_stage"}),
    ("nearest", "deferred", "micro", {"deferred_tail", "vertex_stage"}),
]


def _path(backend, path):
    # The engine's path option; the comparator has no paths.
    return {"path": path} if backend == "cuda" else {}


@pytest.mark.parametrize("tex_filter,tex_mode,path,called", ENGINE_CASES)
def test_engine_calls_the_stages_and_xla_does_not(
        port, small, texture, monkeypatch, tex_filter, tex_mode, path,
        called):
    # The engine's frame reaches the stage wrappers (the kernels on the
    # card); the xla comparator never does, so its frames launch none of
    # the five kernels (its own common.* chain).
    calls = dict.fromkeys(texture.WRAPPERS, 0)
    for name, fn in texture.WRAPPERS.items():
        def counted(*a, _name=name, _fn=fn, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(texture, name, counted)
    s = _textured_scenes(port, small, tex_filter)
    u = s.update(1.0 / 60.0)
    frames = {}
    for backend in ("xla", "cuda"):
        r = port.renderer.Renderer(s.mesh, 128, 96, device="cpu",
                                   backend=backend, tex_mode=tex_mode,
                                   **_path(backend, path),
                                   **s.renderer_options())
        before = dict(calls)
        frames[backend] = r.render(u)
        ran = {n for n in calls if calls[n] > before[n]}
        assert ran == (called if backend == "cuda" else set()), backend
    np.testing.assert_array_equal(frames["xla"], frames["cuda"])
    assert all(port.tracing.count("launches." + name) == 0
               for name in texture.WRAPPERS)


# --------------------------------------------------------------------------
# On the card: each kernel against its plain version on the same tensors
# --------------------------------------------------------------------------

def _assert_rgba_close(k, p, what):
    d = (k.cpu().to(int) - p.cpu().to(int)).abs()
    assert int(d.max()) <= 1, f"{what}: RGBA differs by {int(d.max())}"


def _window(port, a, device, pad=(0, 8, 32)):
    """``a`` (C, H, W) as a window of a larger padded buffer on the card:
    the kernels read it through its strides."""
    t = port.torch
    big = t.zeros(tuple(n + p for n, p in zip(a.shape, pad)),
                  dtype=t.from_numpy(a[:0]).dtype, device=device)
    view = big[tuple(slice(0, n) for n in a.shape)]
    view.copy_(t.from_numpy(np.ascontiguousarray(a)))
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("pool", ["f32", "packed"])
@pytest.mark.parametrize("tex_filter", FLAT_FILTERS)
def test_texture_tail_on_card(port, small, texture, cuda_device, tex_filter,
                              pool):
    from compute_renderer_torch.io.textures import pack_pool_u8

    mesh = small["mesh"]
    rng = np.random.default_rng(31)
    g, key = _gbuffer(rng, 120, 200, 2, mesh.tex_table)
    g = _nan_gbuffer(rng, g, key, 8)
    t = port.torch
    dev = lambda a: t.from_numpy(a).to(cuda_device)
    gk = _window(port, g, cuda_device)
    kk = _window(port, key.view(np.int32)[None], cuda_device)[0]
    packed = dev(pack_pool_u8(mesh.texels)) if pool == "packed" else None
    args = (dev(mesh.texels), dev(LIGHTS[1]), dev(LIGHTS[2]))
    before = port.tracing.count("launches.texture_tail")
    k = texture.texture_tail(gk, kk, *args, tex_filter=tex_filter,
                             texels_packed=packed)
    assert port.tracing.count("launches.texture_tail") == before + 1
    p = texture.texture_tail_plain(gk, kk, *args, tex_filter=tex_filter,
                                   texels_packed=packed)
    _assert_rgba_close(k, p, f"texture_tail {tex_filter} {pool}")


@pytest.mark.cuda
@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_texture_tail_mip_on_card(port, port_frame, texture, cuda_device,
                                  tex_filter):
    rng = np.random.default_rng(32)
    g, key = _mip_gbuffer(rng, 120, 200, 2, port_frame["mips"])
    g = _nan_gbuffer(rng, g, key, 10)
    t = port.torch
    dev = lambda a: t.from_numpy(a).to(cuda_device)
    gk = _window(port, g, cuda_device)
    kk = _window(port, key.view(np.int32)[None], cuda_device)[0]
    args = (dev(port_frame["pool"]), dev(port_frame["mips"]),
            dev(LIGHTS[1]), dev(LIGHTS[2]))
    before = port.tracing.count("launches.texture_tail_mip")
    k = texture.texture_tail_mip(gk, kk, *args, tex_filter=tex_filter)
    assert port.tracing.count("launches.texture_tail_mip") == before + 1
    p = texture.texture_tail_mip_plain(gk, kk, *args, tex_filter=tex_filter)
    _assert_rgba_close(k, p, f"texture_tail_mip {tex_filter}")


@pytest.mark.cuda
@pytest.mark.parametrize("effect", ["none", "wave"])
@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_mip_rows_on_card(port, port_frame, texture, cuda_device, tex_filter,
                          effect):
    # Bitwise (NaN positions equal); the wave frame within 1 ULP (its
    # sinf inputs, as the front's table).
    f = port_frame
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
    tri, face_tex = _padded(f)
    eff = (np.array([1.0, 0.3, 2.0, 0.2, 2.0, 0.5], np.float32)
           if effect == "wave" else f["eff"])
    args = (dev(f["mesh"].positions), dev(tri), dev(f["mesh"].uvs),
            dev(face_tex), dev(f["mips"]), dev(f["vp"]), dev(eff), W, H,
            tex_filter)
    before = port.tracing.count("launches.mip_rows")
    k = texture.mip_rows(*args).cpu().numpy()
    assert port.tracing.count("launches.mip_rows") == before + 1
    p = texture.mip_rows_plain(*args).cpu().numpy()
    if effect == "none":
        assert_bitwise_nan(k, p)
    else:
        np.testing.assert_array_equal(np.isnan(k), np.isnan(p))
        keep = ~np.isnan(k)
        assert int(ulps(k[keep], p[keep]).max()) <= 1


@pytest.fixture(scope="module")
def port_vertex_frame(port, port_frame):
    """``port_frame`` with the port's own per-vertex world and screen (the
    card's machine has no JAX)."""
    t = port.torch
    world, screen = port.common.vertex_stage(
        t.from_numpy(port_frame["mesh"].positions),
        t.from_numpy(port_frame["vp"]), t.from_numpy(port_frame["eff"]), W,
        H)
    return dict(port_frame, world=world.numpy(), screen=screen.numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("path", ["tile", "micro"])
@pytest.mark.parametrize("tex_filter", FILTERS)
def test_deferred_tail_on_card(port, port_vertex_frame, texture, cuda_device,
                               tex_filter, path):
    frame = port_vertex_frame
    for effect in ("none", "mirage"):
        for name, win in WINDOWS.items():
            if path == "tile":
                ids = _winners(frame, 8)[:win[3], :win[2]]
                key = np.where(ids >= 0, 7, 0xFFFFFFFF).astype(np.uint32)
                pair_tri = None
            else:
                pair_tri, ids, key = _pairs(frame)
                ids, key = ids[:win[3], :win[2]], key[:win[3], :win[2]]
            run = lambda fn=None: _deferred_port(
                port, texture, frame, ids, key, effect, tex_filter, win,
                pair_tri=pair_tri, device=cuda_device, fn=fn)
            before = port.tracing.count("launches.deferred_tail")
            k = run()
            assert port.tracing.count("launches.deferred_tail") == before + 1
            p = run(texture.deferred_tail_plain)
            _assert_rgba_close(k, p, f"deferred {tex_filter} {path} "
                               f"{effect} {name}")


@pytest.mark.cuda
@pytest.mark.parametrize("tex_filter,tex_mode,path,called", ENGINE_CASES)
def test_engine_launches_the_stages_on_card(port, small, texture,
                                            cuda_device, tex_filter,
                                            tex_mode, path, called):
    s = _textured_scenes(port, small, tex_filter)
    u = s.update(1.0 / 60.0)
    frames = {}
    for backend in ("xla", "cuda"):
        before = {n: port.tracing.count("launches." + n)
                  for n in texture.WRAPPERS}
        r = port.renderer.Renderer(s.mesh, 128, 96, device=cuda_device,
                                   backend=backend, tex_mode=tex_mode,
                                   **_path(backend, path),
                                   **s.renderer_options())
        frames[backend] = r.render(u)
        ran = {n for n in texture.WRAPPERS
               if port.tracing.count("launches." + n) > before[n]}
        assert ran == (called if backend == "cuda" else set()), backend
    assert_frames_match(frames["xla"], frames["cuda"])
