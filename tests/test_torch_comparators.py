"""The port's comparator backends (``backends/xla.py``,
``backends/wgpu_faithful.py``) against the JAX package, at 64x48 unless
a test says otherwise.

Tolerances, by reference:

- the port's xla against the JAX xla (compiled) and the NumPy oracle
  (``compute_renderer_tpu/golden/rasterizer.py``) on the cases of
  tests/test_xla_backend.py:53-132: that file's contract, at most 0.3% of
  the pixels more than 1 LSB off (XLA:CPU contracts mul+add into FMA,
  which flips exact-edge samples; libm differs by an ULP);
- winner ids and depth keys against the JAX xla run op by op
  (``jax.disable_jit()``, no contraction): bitwise;
- the port's xla at every chunk and grouping, wgpu-faithful with and
  without its pixel windows, and the port's xla against the port's
  engine (``cuda``) on the CPU twins: bitwise (the same floats in the
  same order);
- the port's wgpu-faithful against the JAX module on the cases of
  tests/test_wgpu_faithful.py:38-337, both depth formats: compiled, at
  most 0.3% of the pixels more than 1 LSB off and coverage (depth < 1)
  differing in at most max(2, H*W/500) pixels (contraction moves the
  clipped vertices, and depth by up to 6e-4 on them); op by op, depth
  bitwise and RGBA within 1 LSB;
- the 1024x768 Suzanne frame of each comparator against
  tests/golden_data/torch_comparators_1024x768.npz (rendered by the JAX
  package, scripts/make_torch_comparators_golden.py): the pixel contract
  of tests/test_torch_slice.py (at most 1,572 pixels more than 2 LSB
  off), and for xla at most as many winner ids differing.
"""

import os

import numpy as np
import pytest

from tests.torch_parity import (  # noqa: F401 (fixtures)
    assert_frames_match, cuda_device, pixel_budget, port, tpu,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_data",
                      "torch_comparators_1024x768.npz")
W, H = 64, 48
MISMATCH_FRAC = 0.003
LIGHTS = (np.array([[0.0, 0.0, 0.0], [-5.0, 3.0, 0.0]], np.float32),
          np.array([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5]], np.float32),
          np.array([1.0, 0.5], np.float32))


def _mismatch(a, b, lsb=1):
    a = np.asarray(a).astype(np.int32)
    b = np.asarray(b).astype(np.int32)
    assert a.shape == b.shape, (a.shape, b.shape)
    return float((np.abs(a - b) > lsb).any(axis=-1).mean())


def _effect(p, kind, t):
    e = {
        "wave_vertical": lambda: p.effects.Effect.wave(
            0.3, 2.0, 1.0, p.effects.WaveDirection.VERTICAL),
        "wave_radial": lambda: p.effects.Effect.wave(
            0.2, 3.0, 1.0, p.effects.WaveDirection.RADIAL),
        "edge_melt": lambda: p.effects.Effect.edge_melt(0.3, 1.0),
        "voxelize": lambda: p.effects.Effect.voxelize(0.5, 1.0),
        "mirage": lambda: p.effects.Effect.mirage(1.5, 0.5, 1.0),
    }[kind]()
    e.update(t)
    return e.uniform(t).as_array()


def _overlap(p):
    a = p.procedural.single_triangle(z=0.0)
    b = p.procedural.single_triangle(z=1.0)
    b.positions[:, 0] += 0.2
    mesh = type(a).concatenate([a, b])
    mesh.normals[3:] = [1, 0, 0]
    return mesh


# name -> (mesh builder, effect (kind, t) or None, orbit camera, w, h);
# tests/test_xla_backend.py's cases.
XLA_CASES = {
    "single_triangle": (lambda p: p.procedural.single_triangle(), None,
                        False, W, H),
    "cube": (lambda p: p.procedural.cube(), None, False, W, H),
    "icosphere": (lambda p: p.procedural.icosphere(2), None, False, W, H),
    "overlapping": (_overlap, None, False, W, H),
    "orbit": (lambda p: p.procedural.cube(), None, True, W, H),
    "wave_vertical": (lambda p: p.procedural.icosphere(1),
                      ("wave_vertical", 0.7), False, W, H),
    "wave_radial": (lambda p: p.procedural.icosphere(1),
                    ("wave_radial", 0.3), False, W, H),
    "edge_melt": (lambda p: p.procedural.icosphere(1), ("edge_melt", 0.5),
                  False, W, H),
    "voxelize": (lambda p: p.procedural.cube(), ("voxelize", 0.8), False,
                 W, H),
    "mirage": (lambda p: p.procedural.cube(), ("mirage", 0.4), False, W, H),
    "behind_camera": (lambda p: p.procedural.single_triangle(z=10.0), None,
                      False, W, H),
    "odd_resolution": (lambda p: p.procedural.cube(), None, False, 61, 47),
}


def _xla_inputs(p, name):
    build, eff, orbit, w, h = XLA_CASES[name]
    mesh = build(p)
    cam = (p.camera.Camera.orbit(3.0, 35.0, 10.0, [0, 0, 0], aspect=w / h)
           if orbit else p.camera.Camera.first_person([0, 0, 3.0],
                                                      aspect=w / h))
    effect = (_effect(p, *eff) if eff is not None
              else p.effects.EffectUniform().as_array())
    return mesh, cam.uniform(), effect, w, h


@pytest.fixture(scope="module")
def comparators():
    from compute_renderer_torch.backends import wgpu_faithful, xla

    return xla, wgpu_faithful


@pytest.mark.parametrize("name", list(XLA_CASES))
def test_xla_matches_jax_and_oracle(port, tpu, comparators, name):
    from compute_renderer_tpu.backends import xla as jax_xla
    from compute_renderer_tpu.golden.rasterizer import render_golden

    xla, _ = comparators
    mesh, u, effect, w, h = _xla_inputs(port, name)
    ours = xla.render(mesh, u, LIGHTS, effect, w, h, device="cpu")
    assert ours.shape == (h, w, 4) and ours.dtype == np.uint8
    ref = jax_xla.render(mesh, u, LIGHTS, effect, w, h)
    golden = render_golden(mesh.positions, mesh.normals, mesh.uvs,
                           mesh.indices, u.view_proj, u.view_position,
                           *LIGHTS, effect, w, h)
    assert _mismatch(ours, ref) <= MISMATCH_FRAC
    assert _mismatch(ours, golden) <= MISMATCH_FRAC
    covered = (ours != np.array([0, 0, 255, 255], np.uint8)).any(-1)
    assert covered.any() == (name != "behind_camera")


@pytest.mark.parametrize("name", ["icosphere", "orbit", "voxelize",
                                  "overlapping"])
def test_xla_ids_and_keys_bitwise_op_by_op(port, tpu, comparators, name):
    # Winner ids and depth keys against the JAX xla run op by op (no FMA
    # contraction): bitwise; RGBA within 1 LSB (pow in the shading is
    # libm's on one side, XLA's on the other).
    from compute_renderer_tpu.backends import xla as jax_xla

    xla, _ = comparators
    torch = port.torch
    mesh, u, effect, w, h = _xla_inputs(port, name)
    args = _frame_args(mesh, u, effect)
    with tpu.jax.disable_jit():
        ref = jax_xla.render_frame(*[tpu.jnp.asarray(a) for a in args],
                                   width=w, height=h, return_tri=True)
    ours = xla.render_frame(*[torch.as_tensor(a) for a in args], width=w,
                            height=h, return_tri=True)
    np.testing.assert_array_equal(ours[2].numpy(), np.asarray(ref[2]))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    diff = np.abs(ours[0].numpy().astype(int) - np.asarray(ref[0]).astype(int))
    assert diff.max() <= 1


def _frame_args(mesh, u, effect, lights=LIGHTS):
    return (np.asarray(mesh.positions, np.float32),
            np.asarray(mesh.normals, np.float32),
            np.asarray(mesh.uvs, np.float32),
            mesh.indices.astype(np.int32).reshape(-1, 3),
            np.asarray(u.view_proj, np.float32),
            np.asarray(u.view_position, np.float32),
            *lights, np.asarray(effect, np.float32))


@pytest.mark.parametrize("chunk", [1, 8, 64])
def test_xla_chunk_size_invariance(port, comparators, chunk):
    xla, _ = comparators
    mesh = port.procedural.icosphere(1)
    u = port.camera.Camera.first_person([0, 0, 3.0], aspect=W / H).uniform()
    eff = port.effects.EffectUniform().as_array()
    ref = xla.render(mesh, u, LIGHTS, eff, W, H, device="cpu", chunk=8)
    out = xla.render(mesh, u, LIGHTS, eff, W, H, device="cpu", chunk=chunk)
    np.testing.assert_array_equal(ref, out)


@pytest.mark.parametrize("grouping", ["separate", "merged"])
@pytest.mark.parametrize("name", ["icosphere", "mirage", "overlapping"])
def test_xla_grouping_invariance(port, comparators, monkeypatch, grouping,
                                 name):
    # Every granule its own step, or every granule in one step: the same
    # frame, ids and keys bit for bit.
    xla, _ = comparators
    torch = port.torch
    mesh, u, effect, w, h = _xla_inputs(port, name)
    args = [torch.as_tensor(a) for a in _frame_args(mesh, u, effect)]
    ref = xla.render_frame(*args, width=w, height=h, chunk=4,
                           return_tri=True)
    if grouping == "separate":
        monkeypatch.setattr(xla, "STEP_ELEMENTS", 0)
    else:
        monkeypatch.setattr(xla, "MERGE_ELEMENTS", 1 << 40)
        monkeypatch.setattr(xla, "STEP_ELEMENTS", 1 << 40)
    groups = xla.window_groups(
        np.array([[0, w, 0, h]] * 3), 4, 12)
    assert len(groups) == (3 if grouping == "separate" else 1)
    out = xla.render_frame(*args, width=w, height=h, chunk=4,
                           return_tri=True)
    for a, b in zip(ref, out):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_window_groups_skip_empty_and_merge():
    from compute_renderer_torch.backends import xla

    windows = np.array([[0, 8, 0, 8], [8, 16, 0, 8], [5, 5, 0, 8],
                        [0, 8, 0, 8]])
    # Two small neighbours merge, an empty granule ends the step, the last
    # granule (3 triangles of the 10) starts another.
    assert xla.window_groups(windows, 3, 10) == [
        (0, 6, 0, 16, 0, 8), (9, 10, 0, 8, 0, 8)]


def test_pack_key_orders_and_roundtrips(port):
    from compute_renderer_torch.backends import xla

    torch = port.torch
    keys = torch.tensor([0, 1, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE],
                        dtype=torch.int64)
    ids = torch.tensor([5, 0, 2**31 - 1, 7, 3], dtype=torch.int64)
    packed = xla.pack_key(keys, ids)
    kbits, back = xla.unpack_key(packed)
    np.testing.assert_array_equal(
        kbits.numpy().view(np.uint32), keys.numpy().astype(np.uint32))
    np.testing.assert_array_equal(back.numpy(), ids.numpy())
    order = np.lexsort((ids.numpy(), keys.numpy()))
    np.testing.assert_array_equal(np.argsort(packed.numpy(), kind="stable"),
                                  order)


def _engine_and_xla(port, scene, w, h, **options):
    from compute_renderer_torch.engine.renderer import Renderer

    u = scene.update(1.0 / 60.0)
    frames = []
    for backend in ("cuda", "xla"):
        opts = dict(options)
        if backend == "xla":
            opts.pop("path", None)
        r = Renderer(scene.mesh, w, h, backend=backend, device="cpu",
                     **opts)
        frames.append(r.render(u))
    return frames


@pytest.fixture(scope="module")
def small_structured(tmp_path_factory):
    """A small build of the structured scene (io/objgen.py) with its MTL
    and map_Kd images, as tests/test_torch_ext.py builds it."""
    from compute_renderer_torch.io import objgen

    d = tmp_path_factory.mktemp("structured")
    path = d / "structured_small.obj"
    objgen.write_structured_obj(path, terrain_n=40, statue_nu=40,
                                statue_nv=24, ruins=20,
                                mtl_text=objgen._STRUCTURED_MTL)
    objgen._write_shared_textures(d)
    return path


@pytest.mark.parametrize("case", ["suzanne", "mirage_micro", "materials",
                                  "textures", "textures_trilinear"])
def test_xla_equals_engine_twins(port, small_structured, case):
    # The engine's frame (the CPU twins of its kernels) and the
    # comparator's are built from the same floats in the same order:
    # bitwise. Mirage covers past the triangles into the covered tile or
    # cell rectangles, so its engine frame takes the micro path, whose
    # 8x8 cells are xla's default rectangles.
    sc = port.scene
    w, h = 96, 64
    if case in ("suzanne", "mirage_micro"):
        eff = (port.effects.Effect.mirage(1.5, 0.5, 1.0)
               if case == "mirage_micro" else None)
        cfg = sc.SceneConfig(model_path="suzanne.obj", effect=eff,
                             camera_config=sc.CameraConfig(distance=3.0))
        opts = {"path": "micro"} if case == "mirage_micro" else {}
    else:
        cfg = sc.SceneConfig(
            model_path=str(small_structured),
            enable_materials=case == "materials",
            enable_textures=case.startswith("textures"),
            texture_filter=("trilinear" if case == "textures_trilinear"
                            else "nearest"),
            camera_config=sc.CameraConfig.first_person((13.566635, 4.0,
                                                        24.0)))
        opts = {}
    scene = sc.Scene.from_config(cfg, w, h)
    opts.update(scene.renderer_options())
    engine, comparator = _engine_and_xla(port, scene, w, h, **opts)
    covered = (comparator != np.array([0, 0, 255, 255], np.uint8)).any(-1)
    assert covered.sum() > 200
    np.testing.assert_array_equal(engine, comparator)


# -- wgpu-faithful -----------------------------------------------------------

def _floor_quad(p, pos, idx):
    nrm = np.tile(np.array([[0, 1, 0]], np.float32), (len(pos), 1))
    return p.types.Mesh(np.asarray(pos, np.float32), nrm,
                        np.zeros((len(pos), 2), np.float32),
                        np.asarray(idx, np.uint32))


def _reversed(p, m):
    return p.types.Mesh(m.positions, m.normals, m.uvs,
                        m.indices.reshape(-1, 3)[:, ::-1].reshape(-1).copy())


def _random_triangles(p, n=60, seed=7):
    rng = np.random.default_rng(seed)
    pos = rng.uniform(-1.5, 1.5, (3 * n, 3)).astype(np.float32)
    pos[:, 2] = rng.uniform(-2.0, 4.0, 3 * n)  # some cross the near plane
    nrm = rng.normal(size=(3 * n, 3)).astype(np.float32)
    return p.types.Mesh(pos, nrm, np.zeros((3 * n, 2), np.float32),
                        np.arange(3 * n, dtype=np.uint32))


# name -> (mesh builder, eye, lights, effect (kind, t) or None);
# tests/test_wgpu_faithful.py's cases (its 128x96 frames here at 64x48).
ONE_LIGHT = (np.array([[0.0, 0.0, 5.0]], np.float32),
             np.ones((1, 3), np.float32), np.ones((1,), np.float32))
WGPU_CASES = {
    "sphere": (lambda p: p.procedural.icosphere(2), (0.0, 0.0, 3.0),
               ONE_LIGHT, None),
    "sphere_wave": (lambda p: p.procedural.icosphere(2), (0.0, 0.0, 3.0),
                    ONE_LIGHT, ("wave_vertical", 0.4)),
    "triangle": (lambda p: p.procedural.single_triangle(), (0.0, 0.0, 3.0),
                 ONE_LIGHT, None),
    "triangle_reversed": (
        lambda p: _reversed(p, p.procedural.single_triangle()),
        (0.0, 0.0, 3.0), ONE_LIGHT, None),
    "quad": (lambda p: p.procedural.quad(z=0.0, size=1.0), (0.0, 0.0, 3.0),
             ONE_LIGHT, None),
    "floor_perspective": (
        lambda p: _floor_quad(p, [[-5, 0, 2], [5, 0, 2], [5, 0, -20],
                                  [-5, 0, -20]], [0, 2, 1, 0, 3, 2]),
        (0.0, 1.0, 3.0),
        (np.array([[0.0, 2.0, -6.0]], np.float32),
         np.ones((1, 3), np.float32), np.ones((1,), np.float32)), None),
    "floor_through_camera": (
        lambda p: _floor_quad(p, [[-50, 0, 50], [50, 0, 50], [50, 0, -50],
                                  [-50, 0, -50]], [0, 1, 2, 0, 2, 3]),
        (0.0, 1.0, 3.0),
        (np.array([[0.0, 2.0, -6.0]], np.float32),
         np.ones((1, 3), np.float32), np.ones((1,), np.float32)), None),
    "random_near_plane": (_random_triangles, (0.0, 0.0, 3.0), LIGHTS, None),
}


@pytest.fixture(scope="module")
def wport(port):
    from compute_renderer_torch.core import types

    port.types = types
    return port


def _wgpu_args(p, name):
    build, eye, lights, eff = WGPU_CASES[name]
    mesh = build(p)
    u = p.camera.Camera.first_person(list(eye), aspect=W / H).uniform()
    effect = (_effect(p, *eff) if eff is not None
              else p.effects.EffectUniform().as_array())
    return _frame_args(mesh, u, effect, lights)


def _wgpu_port(p, args, **kw):
    from compute_renderer_torch.backends import wgpu_faithful

    rgba, depth = wgpu_faithful.render_frame(
        *[p.torch.as_tensor(a) for a in args], width=W, height=H, **kw)
    return rgba.numpy(), depth.numpy()


@pytest.mark.parametrize("depth_format", ["float32", "unorm24"])
@pytest.mark.parametrize("name", list(WGPU_CASES))
def test_wgpu_matches_jax(wport, tpu, name, depth_format):
    from compute_renderer_tpu.backends import wgpu_faithful as jax_wgpu

    args = _wgpu_args(wport, name)
    rgba, depth = _wgpu_port(wport, args, depth_format=depth_format)
    ref_rgba, ref_depth = jax_wgpu.render_frame(
        *[tpu.jnp.asarray(a) for a in args], width=W, height=H,
        depth_format=depth_format)
    ref_rgba, ref_depth = np.asarray(ref_rgba), np.asarray(ref_depth)
    assert rgba.shape == (H, W, 4) and depth.dtype == np.float32
    assert _mismatch(rgba, ref_rgba) <= MISMATCH_FRAC
    assert int(((depth < 1.0) != (ref_depth < 1.0)).sum()) <= \
        pixel_budget(H, W)
    with tpu.jax.disable_jit():
        op_rgba, op_depth = jax_wgpu.render_frame(
            *[tpu.jnp.asarray(a) for a in args], width=W, height=H,
            depth_format=depth_format)
    np.testing.assert_array_equal(depth, np.asarray(op_depth))
    assert np.abs(rgba.astype(int) - np.asarray(op_rgba).astype(int)).max() \
        <= 1


def test_wgpu_properties(wport):
    # tests/test_wgpu_faithful.py's claims, on the port: the sphere on the
    # blue clear, effects ignored, CCW culling, no seam along a shared
    # edge, the floor drawn through the near plane, unorm24 moving depth
    # below its step only.
    rgba, depth = _wgpu_port(wport, _wgpu_args(wport, "sphere"))
    assert (depth < 1.0).sum() > 150
    assert tuple(rgba[0, 0]) == (0, 0, 255, 255) and depth[0, 0] == 1.0
    waved, _ = _wgpu_port(wport, _wgpu_args(wport, "sphere_wave"))
    np.testing.assert_array_equal(rgba, waved)
    _, d_front = _wgpu_port(wport, _wgpu_args(wport, "triangle"))
    _, d_back = _wgpu_port(wport, _wgpu_args(wport, "triangle_reversed"))
    assert (d_front < 1.0).any() and (d_back == 1.0).all()
    _, dq = _wgpu_port(wport, _wgpu_args(wport, "quad"))
    ys, xs = np.nonzero(dq < 1.0)
    assert (dq[ys.min() + 2:ys.max() - 2, xs.min() + 2:xs.max() - 2]
            < 1.0).all()
    _, dfloor = _wgpu_port(wport, _wgpu_args(wport, "floor_through_camera"))
    assert (dfloor < 1.0).sum() > 0.2 * W * H
    _, d24 = _wgpu_port(wport, _wgpu_args(wport, "sphere"),
                        depth_format="unorm24")
    assert ((d24 < 1.0) == (depth < 1.0)).all()
    assert np.abs(d24 - depth).max() <= 2.0 / (1 << 24)


def test_wgpu_srgb_encode(port):
    from compute_renderer_torch.backends import wgpu_faithful

    lin = port.torch.tensor([0.0, 0.002, 0.0031308, 0.18, 0.5, 1.0])
    enc = wgpu_faithful._srgb_encode(lin).numpy()
    expect = np.array([0.0, 0.02584, 0.04045, 0.46135613, 0.73536, 1.0],
                      np.float32)
    np.testing.assert_allclose(enc, expect, atol=2e-4)


@pytest.mark.parametrize("name", ["sphere", "floor_through_camera",
                                  "random_near_plane", "quad"])
def test_wgpu_windows_and_chunks_invariant(wport, monkeypatch, name):
    # The one-pixel-widened windows cut no covered pixel, and the chunk
    # changes nothing: the same frame and depth as every sub-triangle
    # tested over the whole frame.
    from compute_renderer_torch.backends import wgpu_faithful

    args = _wgpu_args(wport, name)
    ref = _wgpu_port(wport, args, chunk=5)
    out = _wgpu_port(wport, args, chunk=64)

    def full(csx, csy, width, height):
        torch = wport.torch
        n = csx.shape[0]
        z = torch.zeros((n,), dtype=torch.int64)
        return z, z + width, z, z + height

    monkeypatch.setattr(wgpu_faithful, "_pixel_windows", full)
    whole = _wgpu_port(wport, args, chunk=7)
    for a, b, c in zip(ref, out, whole):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)


# -- the renderer and the 1024x768 golden -----------------------------------

@pytest.mark.parametrize("backend", ["xla", "wgpu-faithful"])
def test_renderer_runs_comparators(port, backend):
    # Every renderer entry point on a comparator, on the CPU: render,
    # render_blocked, render_batch_device (checked and not), the fence and
    # the overflow flush (always clear); frames equal the backend's own.
    from compute_renderer_torch.backends import get_backend

    sc = port.scene
    scene = sc.Scene.from_config(
        sc.SceneConfig(model_path="suzanne.obj", backend_type=backend,
                       camera_config=sc.CameraConfig(distance=3.0)), W, H)
    # "wgpu" is the reference's name of the xla comparator.
    alias = {"xla": "wgpu"}.get(backend, backend)
    r = port.renderer.Renderer(scene.mesh, W, H, backend=alias,
                               device="cpu", **scene.renderer_options())
    assert r.backend is get_backend(backend) and r.effect_kind is None
    us = [scene.update(0.1) for _ in range(3)]
    single = [r.render(u) for u in us]
    batch = r.render_batch_device(us).numpy()
    unchecked = r.render_batch_device(us, check=False).numpy()
    r.fence_pending()
    assert not r.flush_overflow()
    np.testing.assert_array_equal(r.render_blocked(us[0]).numpy(),
                                  single[0])
    for i in range(3):
        np.testing.assert_array_equal(batch[i], single[i])
        np.testing.assert_array_equal(unchecked[i], single[i])
    rgba, _ = get_backend(backend).render_frame(
        r.positions, r.normals, r.uvs, r.tri,
        *_uniform_tensors(port, us[0]), width=W, height=H)
    np.testing.assert_array_equal(rgba.numpy(), single[0])


def _uniform_tensors(port, u):
    t = port.torch.as_tensor
    return (t(u.view_proj), t(u.view_position), t(u.light_world_pos),
            t(u.light_color), t(u.light_intensity), t(u.effect))


def test_renderer_rejects_engine_options_on_comparators(port):
    mesh = port.procedural.make_model("suzanne.obj")
    with pytest.raises(NotImplementedError):
        port.renderer.Renderer(mesh, W, H, backend="xla", device="cpu",
                               pair_cap=64)
    with pytest.raises(ValueError):
        port.renderer.Renderer(mesh, W, H, backend="vulkan", device="cpu")


def _golden_scene(port, backend):
    sc = port.scene
    cfg = sc.SceneConfig(
        model_path="suzanne.obj", backend_type=backend,
        camera_config=sc.CameraConfig(
            distance=2.0, mode=port.camera.CameraMode.FIRST_PERSON,
            position=(0.0, 0.0, 3.0)))
    return sc.Scene.from_config(cfg, 1024, 768)


@pytest.mark.parametrize("backend", ["xla", "wgpu-faithful"])
def test_suzanne_1024x768_against_golden(port, backend):
    from compute_renderer_torch.backends import get_backend

    golden = np.load(GOLDEN)
    row = "suzanne_xla" if backend == "xla" else "suzanne_wgpu"
    scene = _golden_scene(port, backend)
    u = scene.update(1.0 / 60.0)
    r = port.renderer.Renderer(scene.mesh, 1024, 768, backend=backend,
                               device="cpu")
    kw = {"return_tri": True} if backend == "xla" else {}
    out = get_backend(backend).render_frame(
        r.positions, r.normals, r.uvs, r.tri, *_uniform_tensors(port, u),
        width=1024, height=768, **kw)
    assert_frames_match(golden[row], out[0].numpy())
    if backend == "xla":
        ids = out[2].numpy()
        assert int((ids != golden[row + "_tri"]).sum()) <= \
            pixel_budget(768, 1024)


@pytest.mark.cuda
@pytest.mark.parametrize("backend", ["xla", "wgpu-faithful"])
def test_comparators_on_card_match_cpu(port, cuda_device, backend):
    # On the card: the comparator's frame against its CPU run (libm may
    # differ by an ULP: the pixel contract), and xla against the engine's
    # graph frame bitwise.
    scene = _golden_scene(port, backend)
    u = scene.update(1.0 / 60.0)
    frames = [port.renderer.Renderer(scene.mesh, 256, 192, backend=backend,
                                     device=d).render(u)
              for d in ("cpu", cuda_device)]
    assert_frames_match(frames[0], frames[1])
    if backend == "xla":
        engine = port.renderer.Renderer(scene.mesh, 256, 192,
                                        device=cuda_device).render(u)
        np.testing.assert_array_equal(engine, frames[1])
