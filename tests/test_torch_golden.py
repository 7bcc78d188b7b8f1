"""The port's NumPy oracle (``compute_renderer_torch/golden/``) against the
JAX package's, and against the port's own renderer.

The oracle is a copy that imports the port's ``core`` modules, so the two
must agree bitwise on every input: the cases of tests/test_golden.py, the
seeded random soups of tests/test_fuzz.py (their generator, seeds and
effects), every effect, per-face ``face_kd``, and each of the four texture
filters on a small atlas made from a seed. Each case compares the RGBA,
the pre-quantization floats (``return_float``) and the G-buffer
(``return_gbuffer``).

Tolerances: oracle against oracle bitwise. The port's engine (CPU twins)
against the port's oracle on the soups without an effect: the gate of
tests/test_fuzz.py:106-127 (at most 0.5% of pixels more than 1 LSB off).
"""

import numpy as np
import pytest

F32 = np.float32
W, H = 64, 64
FUZZ_W, FUZZ_H = 128, 48
SEEDS = [3, 57, 7, 23, 101, 11, 42, 5]


def _oracles():
    from compute_renderer_tpu.golden.rasterizer import render_golden as jax_rg
    from compute_renderer_torch.golden import render_golden as port_rg

    return jax_rg, port_rg


def assert_oracles_agree(*args, **kw):
    """Both oracles on the same inputs: RGBA, floats and G-buffer
    bitwise. Returns the port's RGBA."""
    jax_rg, port_rg = _oracles()
    j_rgba, j_f, j_g = jax_rg(*args, return_gbuffer=True, return_float=True,
                              **kw)
    p_rgba, p_f, p_g = port_rg(*args, return_gbuffer=True, return_float=True,
                               **kw)
    np.testing.assert_array_equal(p_rgba, j_rgba)
    np.testing.assert_array_equal(p_f, j_f)
    assert sorted(p_g) == sorted(j_g)
    for k in j_g:
        assert p_g[k].dtype == j_g[k].dtype, k
        np.testing.assert_array_equal(p_g[k], j_g[k], err_msg=k)
    np.testing.assert_array_equal(port_rg(*args, **kw), p_rgba)
    return p_rgba


def _camera_args(mesh, cam, lights, effect, w, h):
    u = cam.uniform()
    return (mesh.positions, mesh.normals, mesh.uvs, mesh.indices,
            u.view_proj, u.view_position, *lights, effect, w, h)


def _default_lights(n=1):
    return (np.tile(np.array([[0, 0, 5.0]], F32), (n, 1)),
            np.ones((n, 3), F32), np.ones((n,), F32))


def _no_effect():
    from compute_renderer_torch.core.effects import EffectUniform

    return EffectUniform().as_array()


# -- the cases of tests/test_golden.py -----------------------------------------

def _golden_case(name):
    from compute_renderer_torch.core.types import Mesh
    from compute_renderer_torch.io import procedural

    tri = procedural.single_triangle
    lights = _default_lights()
    if name == "background":
        return tri(z=100.0), lights
    if name == "single":
        return tri(z=0.0), lights
    if name == "backface":
        m = tri(z=0.0)
        m.indices = m.indices[::-1].copy()
        return m, lights
    if name in ("depth_order", "depth_tie"):
        a, b = ((tri(z=0.0), tri(z=1.0)) if name == "depth_order"
                else (tri(z=0.0), tri(z=0.0)))
        both = Mesh.concatenate([a, b])
        both.normals[:3] = [1, 0, 0] if name == "depth_order" else [0, 0, 1]
        both.normals[3:] = [0, 0, 1] if name == "depth_order" else 0.5
        return both, lights
    if name == "near_plane":
        m = tri(z=0.0)
        m.positions[2, 2] = 10.0
        return m, lights
    if name == "scaled_normals":
        m = tri(z=0.0)
        m.normals = m.normals * 0.25
        return m, lights
    if name == "black_light":
        return tri(z=0.0), (lights[0], np.zeros((1, 3), F32), lights[2])
    assert name == "two_lights"
    return tri(z=0.0), _default_lights(2)


GOLDEN_CASES = ["background", "single", "backface", "depth_order",
                "depth_tie", "near_plane", "scaled_normals", "black_light",
                "two_lights"]


@pytest.mark.parametrize("name", GOLDEN_CASES)
def test_golden_cases_bitwise(name):
    from compute_renderer_torch.core.camera import Camera

    mesh, lights = _golden_case(name)
    cam = Camera.first_person([0, 0, 3.0], aspect=W / H)
    img = assert_oracles_agree(
        *_camera_args(mesh, cam, lights, _no_effect(), W, H))
    covered = (img != [0, 0, 255, 255]).any(axis=-1)
    if name in ("background", "backface", "near_plane"):
        assert not covered.any()
    else:
        assert covered[H // 2, W // 2]


def test_stage_helpers_bitwise():
    from compute_renderer_tpu.golden import rasterizer as jr
    from compute_renderer_torch.core.camera import Camera
    from compute_renderer_torch.golden import rasterizer as pr

    u = Camera.first_person([0, 0, 3.0], aspect=W / H).uniform()
    pos = np.random.default_rng(1).uniform(-1, 1, (9, 3)).astype(F32)
    for effect in (_no_effect(), np.array([1, 0.3, 2.0, 1.0, 2.0, 0.5],
                                          F32)):
        for a, b in zip(jr.vertex_stage(pos, u.view_proj, effect, W, H),
                        pr.vertex_stage(pos, u.view_proj, effect, W, H)):
            np.testing.assert_array_equal(a, b)
        screen = pr.vertex_stage(pos, u.view_proj, effect, W, H)[1]
        idx = np.arange(9, dtype=np.uint32)
        js = jr.triangle_setup(screen, idx, effect, W, H, 8)
        ps = pr.triangle_setup(screen, idx, effect, W, H, 8)
        for k in js:
            np.testing.assert_array_equal(ps[k], js[k], err_msg=k)


# -- the seeded soups of tests/test_fuzz.py ------------------------------------

def _soup(seed):
    """tests/test_fuzz.py's draws for ``seed``: soup, camera, lights and a
    random effect (the JAX package's classes; the arrays are numpy)."""
    from tests.test_fuzz import (
        random_camera, random_effect, random_lights, random_soup,
    )

    rng = np.random.default_rng(seed)
    mesh = random_soup(rng, int(rng.integers(5, 40)))
    cam = random_camera(rng)
    lights = random_lights(rng, int(rng.integers(1, 4)))
    return mesh, cam, lights, random_effect(rng)


@pytest.mark.parametrize("seed", SEEDS)
def test_fuzz_soups_bitwise(seed):
    mesh, cam, lights, effect = _soup(seed)
    assert_oracles_agree(
        *_camera_args(mesh, cam, lights, effect, FUZZ_W, FUZZ_H))
    assert_oracles_agree(
        *_camera_args(mesh, cam, lights, _no_effect(), FUZZ_W, FUZZ_H))


@pytest.mark.parametrize("path", ["tile", "micro"])
@pytest.mark.parametrize("seed", [3, 57])
def test_engine_within_fuzz_gate_of_port_oracle(seed, path):
    # The gate the JAX package holds its comparator to
    # (tests/test_fuzz.py:106-127), on the port's engine (CPU twins).
    from compute_renderer_torch.engine.renderer import Renderer
    from compute_renderer_torch.engine.scene import FrameUniforms
    from compute_renderer_torch.golden import render_golden
    from tests.test_fuzz import random_camera, random_lights, random_soup

    rng = np.random.default_rng(seed)
    mesh = random_soup(rng, int(rng.integers(5, 30)))
    cam = random_camera(rng)
    lights = random_lights(rng, 2)
    args = _camera_args(mesh, cam, lights, _no_effect(), FUZZ_W, FUZZ_H)
    gold = render_golden(*args)
    u = cam.uniform()
    uni = FrameUniforms(view_position=u.view_position, view_proj=u.view_proj,
                        light_world_pos=lights[0], light_color=lights[1],
                        light_intensity=lights[2], effect=_no_effect())
    ours = Renderer(mesh, FUZZ_W, FUZZ_H, device="cpu", path=path).render(uni)
    mismatched = (np.abs(ours.astype(int) - gold.astype(int)) > 1).any(-1)
    assert mismatched.mean() <= 0.005, f"{mismatched.sum()} px differ"


# -- every effect, materials, textures ------------------------------------------

def _effects():
    from compute_renderer_torch.core.effects import Effect, WaveDirection

    out = {"wave_" + d.name.lower(): Effect.wave(0.3, 4.0, 2.0, d)
           for d in WaveDirection}
    out.update(edge_melt=Effect.edge_melt(0.3, 1.5),
               voxelize=Effect.voxelize(0.4, 1.5),
               mirage=Effect.mirage(0.8, 0.7, 0.3))
    return out


@pytest.mark.parametrize("name", sorted(_effects()))
def test_every_effect_bitwise(name):
    from compute_renderer_torch.core.camera import Camera
    from compute_renderer_torch.io import procedural

    effect = _effects()[name]
    t = 0.7
    effect.update(t)
    mesh = procedural.icosphere(2)
    cam = Camera.orbit(3.0, 20.0, 10.0, [0, 0, 0], aspect=96 / 64)
    assert_oracles_agree(*_camera_args(
        mesh, cam, _default_lights(2), effect.uniform(t).as_array(), 96, 64))


def test_face_kd_bitwise():
    from compute_renderer_torch.core.camera import Camera
    from compute_renderer_torch.io import procedural

    mesh = procedural.icosphere(2)
    kd = np.random.default_rng(4).uniform(0, 1, (mesh.num_triangles, 3))
    cam = Camera.orbit(3.0, -30.0, 15.0, [0, 0, 0], aspect=96 / 64)
    assert_oracles_agree(*_camera_args(
        mesh, cam, _default_lights(2), _no_effect(), 96, 64),
        face_kd=kd.astype(F32))


def _atlas(seed=9):
    """A small atlas of three textures of uneven sizes, made from a seed,
    and per-face slots (-1: untextured)."""
    rng = np.random.default_rng(seed)
    sizes = [(8, 4), (5, 7), (16, 16)]
    texels, table, off = [], [], 0
    for tw, th in sizes:
        texels.append(rng.uniform(0, 1, (tw * th, 3)).astype(F32))
        table.append([off, tw, th])
        off += tw * th
    return np.concatenate(texels), np.array(table, np.int32), rng


@pytest.mark.parametrize("tex_filter", ["nearest", "bilinear", "trilinear",
                                        "anisotropic"])
def test_texture_filters_bitwise(tex_filter):
    from compute_renderer_tpu.io.textures import build_mips as jax_mips
    from compute_renderer_torch.core.camera import Camera
    from compute_renderer_torch.io import procedural
    from compute_renderer_torch.io.textures import build_mips

    mesh = procedural.icosphere(2)
    texels, table, rng = _atlas()
    face_tex = rng.integers(-1, 3, (mesh.num_triangles,)).astype(np.int32)
    # uvs past [0, 1) exercise the repeat wrap; steep ones the mip lod.
    uvs = rng.uniform(-2, 3, mesh.uvs.shape).astype(F32)
    kw = dict(face_tex=face_tex, tex_table=table, tex_filter=tex_filter)
    if tex_filter in ("trilinear", "anisotropic"):
        pool, mips = build_mips(texels, table)
        j_pool, j_mips = jax_mips(texels, table)
        np.testing.assert_array_equal(pool, j_pool)
        np.testing.assert_array_equal(mips, j_mips)
        kw.update(texels=pool, tex_mips=mips)
    else:
        kw.update(texels=texels)
    cam = Camera.orbit(3.0, 40.0, -10.0, [0, 0, 0], aspect=96 / 64)
    u = cam.uniform()
    lights = _default_lights(2)
    img = assert_oracles_agree(
        mesh.positions, mesh.normals, uvs, mesh.indices, u.view_proj,
        u.view_position, *lights, _no_effect(), 96, 64, **kw)
    assert (img != [0, 0, 255, 255]).any(axis=-1).sum() > 100
