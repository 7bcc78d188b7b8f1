"""Host modules of the PyTorch port against the JAX package: procedural
meshes, scene updates, the packed uniforms, and what the port must not
import. Everything here is numpy on both sides, so equality is bitwise."""

import os
import subprocess
import sys

import numpy as np
import pytest

from tests.torch_parity import port, tpu  # noqa: F401 (fixtures)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The procedural stand-ins: the tile path renders the first four, the
# micro path the ~1M-triangle mega stand-ins.
MODELS = (
    "suzanne.obj",
    "san_miguel_small.obj",
    "vokselia_spawn_small.obj",
    "exterior/Exterior.obj",
    "San_Miguel/san-miguel-low-poly.obj",
    "vokselia_spawn/vokselia_spawn.obj",
)


@pytest.mark.parametrize("name", MODELS)
def test_procedural_mesh_arrays(port, tpu, name):
    a = tpu.procedural.make_model(name)
    b = port.procedural.make_model(name)
    for field in ("positions", "normals", "uvs", "indices"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


def _scene_pair(port, tpu, mode, effect):
    W, H = 320, 240
    cams = []
    for pkg in (tpu, port):
        cam_mode = pkg.camera.CameraMode.ORBIT if mode == "orbit" else \
            pkg.camera.CameraMode.FIRST_PERSON
        cc = pkg.scene.CameraConfig(distance=3.5, theta=20.0, phi=10.0,
                                    mode=cam_mode, position=(0.3, 0.2, 3.0))
        eff = None
        if effect == "wave":
            eff = pkg.effects.Effect.wave(
                0.4, 3.0, 2.0, pkg.effects.WaveDirection.RADIAL)
        elif effect == "voxelize":
            eff = pkg.effects.Effect.voxelize(0.3, 1.5)
        cfg = pkg.scene.SceneConfig(model_path="suzanne.obj", effect=eff,
                                    camera_config=cc)
        cams.append(pkg.scene.Scene.from_config(cfg, W, H))
    return cams


@pytest.mark.parametrize("mode", ["orbit", "first-person"])
@pytest.mark.parametrize("effect", [None, "wave", "voxelize"])
def test_scene_update_uniforms(port, tpu, mode, effect):
    js, ts = _scene_pair(port, tpu, mode, effect)
    # The same options, effect_kind included (the port's tile tuner reads
    # it).
    assert js.renderer_options() == ts.renderer_options()
    for _ in range(5):
        for s in (js, ts):
            s.get_active_camera().update_over_time(0.05)
        a, b = js.update(0.05), ts.update(0.05)
        for field in ("view_position", "view_proj", "light_world_pos",
                      "light_color", "light_intensity", "effect"):
            x, y = getattr(a, field), getattr(b, field)
            assert np.asarray(x).dtype == np.asarray(y).dtype, field
            np.testing.assert_array_equal(x, y, err_msg=field)


def test_pack_uniforms_bitwise(port, tpu):
    js, ts = _scene_pair(port, tpu, "orbit", "wave")
    a, la = tpu.renderer.Renderer.pack_uniforms(js.update(0.1))
    b, lb = port.renderer.Renderer.pack_uniforms(ts.update(0.1))
    assert la == lb
    np.testing.assert_array_equal(a, b)
    # unpack is the exact inverse, on torch tensors.
    parts = port.renderer.unpack_uniforms(port.torch.from_numpy(b), lb)
    ref = tpu.renderer.unpack_uniforms(a, la)
    for x, y in zip(ref, parts):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("lights", [1, 2, 4])
def test_pack_into_writes_its_row_alone(port, tpu, lights, dtype):
    # pack_into into one row of a larger buffer (as the card's staging
    # buffer is written): the row holds exactly pack_uniforms' bytes, which
    # are the JAX package's, float64 fields rounded alike, and nothing
    # outside the row changes.
    rng = np.random.default_rng(lights)
    u = port.scene.FrameUniforms(
        view_position=rng.standard_normal(4).astype(dtype),
        view_proj=rng.standard_normal((4, 4)).astype(dtype),
        light_world_pos=rng.standard_normal((lights, 3)).astype(dtype),
        light_color=rng.uniform(0, 1, (lights, 3)).astype(dtype),
        light_intensity=rng.uniform(0, 4, lights).astype(dtype),
        effect=rng.standard_normal(6).astype(dtype))
    P = port.renderer.packed_size(lights)
    fill = np.float32(-7.5)
    buf = np.full((3, P + 5), fill, np.float32)
    port.renderer.pack_into(buf[1, 2:2 + P], u)
    want, L = port.renderer.Renderer.pack_uniforms(u)
    ref, _ = tpu.renderer.Renderer.pack_uniforms(u)
    assert L == lights and want.dtype == np.float32 and want.shape == (P,)
    np.testing.assert_array_equal(want.view(np.uint32), ref.view(np.uint32))
    np.testing.assert_array_equal(buf[1, 2:2 + P].view(np.uint32),
                                  want.view(np.uint32))
    outside = np.ones(buf.shape, bool)
    outside[1, 2:2 + P] = False
    assert (buf[outside] == fill).all()


def test_convert_carries_jax_state(port, tpu):
    mesh = tpu.procedural.make_model("suzanne.obj")
    m = port.convert.mesh_from_arrays(mesh.positions, mesh.normals,
                                      mesh.uvs, mesh.indices)
    assert m.num_triangles == mesh.num_triangles
    np.testing.assert_array_equal(m.indices, mesh.indices)
    np.testing.assert_array_equal(m.positions, mesh.positions)
    js, _ = _scene_pair(port, tpu, "first-person", "wave")
    u = js.update(0.02)
    v = port.convert.uniforms_from_arrays(
        u.view_position, u.view_proj, u.light_world_pos, u.light_color,
        u.light_intensity, u.effect)
    for field in ("view_position", "view_proj", "effect"):
        np.testing.assert_array_equal(getattr(u, field), getattr(v, field))
        assert getattr(v, field).dtype == np.float32


def test_model_load_obj_on_disk_not_ported(port, tmp_path):
    # An OBJ file on disk loads through the port's own loaders (the native
    # parser, tests/test_torch_native.py); unknown names still raise and
    # the procedural stand-ins still resolve.
    from compute_renderer_torch.io.model import Model

    obj = tmp_path / "tri.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    model = Model.load(str(obj))
    assert model.source == str(obj) and model.num_triangles == 1
    np.testing.assert_array_equal(model.mesh.indices, [0, 1, 2])
    assert model.mesh.face_kd is None and not model.mesh.has_textures
    with pytest.raises(FileNotFoundError):
        Model.load("no_such_model.obj")
    assert Model.load("suzanne.obj").num_triangles == 1280


def test_port_never_imports_jax():
    code = (
        "import sys\n"
        "import compute_renderer_torch\n"
        "from compute_renderer_torch.backends import (cuda, expand, front,"
        " micro, raster)\n"
        "from compute_renderer_torch import cli, convert\n"
        "from compute_renderer_torch.app import webview, window\n"
        "from compute_renderer_torch.golden import rasterizer\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('compute_renderer_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_port_sources_name_no_jax():
    pkg = os.path.join(ROOT, "compute_renderer_torch")
    offenders = []
    for dirpath, _, files in os.walk(pkg):
        for f in files:
            if not f.endswith((".py", ".cu", ".cuh")):
                continue
            text = open(os.path.join(dirpath, f)).read()
            for needle in ("import jax", "from jax", "compute_renderer_tpu"):
                if needle in text:
                    offenders.append((f, needle))
    for script in ("chip_smoke.py", "bench_torch.py"):
        with open(os.path.join(ROOT, script)) as fh:
            text = fh.read()
        for needle in ("import jax", "from jax", "compute_renderer_tpu."):
            if needle in text:
                offenders.append((script, needle))
    assert not offenders, offenders
