"""Stage math of the tile path (backends/common.py) against the JAX package.

Float outputs are compared within rtol=2e-6, atol=1e-6 (the
tests/test_front_kernel.py:63 contract): XLA:CPU contracts mul+add into
FMA, eager torch does not. Integer outputs are compared bitwise when both
packages get the same numpy inputs."""

import numpy as np
import pytest

from tests.torch_parity import W, H, assert_close_nan, port, tpu  # noqa: F401

EFFECTS = {
    "none": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "wave_vertical": [1.0, 0.4, 3.0, 0.7, 0.0, 1.3],
    "wave_horizontal": [1.0, 0.3, 2.0, 0.2, 1.0, 0.5],
    "wave_radial": [1.0, 0.5, 4.0, 1.1, 2.0, 0.9],
    "edge_melt": [2.0, 0.25, 0.8, 0.0, 0.0, 2.1],
    "voxelize": [3.0, 0.35, 0.0, 0.0, 0.0, 0.4],
    "mirage": [4.0, 0.6, 0.05, 0.3, 1.0, 1.7],
}


def _view_proj(tpu, position=(0.2, -0.1, 3.0)):
    cam = tpu.camera.Camera.first_person(list(position), aspect=W / H)
    return cam.uniform().view_proj


def _positions(seed, n=600):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, 3)) * 1.3).astype(np.float32)


@pytest.mark.parametrize("effect", ["none", "wave_vertical",
                                    "wave_horizontal", "wave_radial"])
def test_apply_wave_effect(port, tpu, effect):
    pos = _positions(1)
    eff = np.asarray(EFFECTS[effect], np.float32)
    a = np.asarray(tpu.common.apply_wave_effect(tpu.jnp.asarray(pos),
                                                tpu.jnp.asarray(eff)))
    b = port.common.apply_wave_effect(port.torch.from_numpy(pos),
                                      port.torch.from_numpy(eff)).numpy()
    assert_close_nan(a, b)


@pytest.mark.parametrize("effect", ["none", "wave_radial", "voxelize"])
def test_vertex_stage(port, tpu, effect):
    pos = _positions(2)
    vp = _view_proj(tpu)
    eff = np.asarray(EFFECTS[effect], np.float32)
    wa, sa = tpu.jax.jit(tpu.common.vertex_stage, static_argnums=(3, 4))(
        tpu.jnp.asarray(pos), tpu.jnp.asarray(vp), tpu.jnp.asarray(eff), W, H)
    t = port.torch
    wb, sb = port.common.vertex_stage(t.from_numpy(pos), t.from_numpy(vp),
                                      t.from_numpy(eff), W, H)
    assert_close_nan(np.asarray(wa), wb.numpy())
    assert_close_nan(np.asarray(sa), sb.numpy())


@pytest.mark.parametrize("tile", [(16, 256), (8, 128), (8, 8)])
@pytest.mark.parametrize("effect", ["none", "voxelize"])
def test_triangle_setup_bitwise(port, tpu, tile, effect):
    # Both packages get the SAME numpy screen vertices (a random soup with
    # off-screen, behind-camera and degenerate triangles mixed in), so the
    # integer rects and the alive mask must agree bit for bit.
    rng = np.random.default_rng(3)
    n = 900
    screen = np.empty((n, 4), np.float32)
    screen[:, 0] = rng.uniform(-80, W + 80, n)
    screen[:, 1] = rng.uniform(-60, H + 60, n)
    screen[:, 2] = rng.uniform(0, 1, n)
    screen[:, 3] = rng.uniform(-0.2, 4, n)
    screen[::97, 0] = np.nan
    tri = rng.integers(0, n, (700, 3)).astype(np.int32)
    tri[::50, 1] = tri[::50, 0]  # degenerate
    eff = np.asarray(EFFECTS[effect], np.float32)
    th, tw = tile
    a = tpu.common.triangle_setup(tpu.jnp.asarray(screen),
                                  tpu.jnp.asarray(tri),
                                  tpu.jnp.asarray(eff), W, H, th, tw)
    t = port.torch
    b = port.common.triangle_setup(t.from_numpy(screen), t.from_numpy(tri),
                                   t.from_numpy(eff), W, H, th, tw)
    for k in ("alive", "tile_x0", "tile_y0", "tile_x1", "tile_y1"):
        x = np.asarray(a[k])
        y = b[k].numpy()
        np.testing.assert_array_equal(x.astype(y.dtype), y, err_msg=k)
    assert 0 < b["alive"].sum() < n


def test_barycentric_coefficients_and_combine(port, tpu):
    rng = np.random.default_rng(4)
    n = 500
    v = rng.uniform(0, 300, (6, n)).astype(np.float32)
    v[2:4, :20] = v[0:2, :20]  # degenerate: NaN coefficients
    w = rng.standard_normal((3, n)).astype(np.float32)
    ca = tpu.common.barycentric_coefficients(*[tpu.jnp.asarray(r) for r in v])
    cb = port.common.barycentric_coefficients(
        *[port.torch.from_numpy(r) for r in v])
    for k in ca:
        assert_close_nan(np.asarray(ca[k]), cb[k].numpy())
    assert np.isnan(cb["a1"].numpy()[:20]).all()
    ra = tpu.common.affine_combine(ca, *[tpu.jnp.asarray(r) for r in w])
    rb = port.common.affine_combine(cb, *[port.torch.from_numpy(r) for r in w])
    for x, y in zip(ra, rb):
        assert_close_nan(np.asarray(x), y.numpy())


@pytest.mark.parametrize("effect", sorted(EFFECTS))
def test_coverage_thresholds(port, tpu, effect):
    eff = np.asarray(EFFECTS[effect], np.float32)
    a = tpu.common.coverage_thresholds(tpu.jnp.asarray(eff))
    b = port.common.coverage_thresholds(port.torch.from_numpy(eff))
    for x, y in zip(a, b):
        assert_close_nan(np.asarray(x), y.numpy())


def test_depth_key_bitwise(port, tpu):
    z = np.array([0.0, -0.0, 0.5, -0.5, 1.0, np.inf, -np.inf, 1e-40, 3e38],
                 np.float32)
    a = np.asarray(tpu.common.depth_key(tpu.jnp.asarray(z)))
    b = port.common.depth_key(port.torch.from_numpy(z)).numpy()
    np.testing.assert_array_equal(a.astype(np.int64), b)
    assert b[1] == 0x80000000  # -0.0


def test_empty_frame(port, tpu):
    ra, ka = tpu.common.empty_frame(W, H)
    rb, kb = port.common.empty_frame(W, H, "cpu")
    np.testing.assert_array_equal(np.asarray(ra), rb.numpy())
    np.testing.assert_array_equal(np.asarray(ka), kb.numpy())
    assert kb.dtype == port.torch.uint32


def test_front_twin_matches_xla_chain_per_corner(port, tpu):
    # The corner-SoA twin re-transforms each corner: the same values as the
    # per-vertex chain of common.vertex_stage -> triangle_setup.
    mesh = tpu.procedural.icosphere(2)
    vp = _view_proj(tpu)
    eff = np.asarray(EFFECTS["none"], np.float32)
    t = port.torch
    pos = t.from_numpy(mesh.positions)
    tri = t.from_numpy(mesh.indices.astype(np.int32)).reshape(-1, 3)
    world, screen = port.common.vertex_stage(pos, t.from_numpy(vp),
                                             t.from_numpy(eff), W, H)
    setup = port.common.triangle_setup(screen, tri, t.from_numpy(eff), W, H,
                                       16, 256)
    soa = port.cuda.corner_soa
    front_table, meta = port.front.front_end_plain(
        soa(pos, tri), soa(t.from_numpy(mesh.normals), tri),
        t.from_numpy(vp), t.from_numpy(eff), width=W, height=H, tile_h=16,
        tile_w=256)
    np.testing.assert_array_equal(meta[0].numpy(), setup["tile_x0"].numpy())
    np.testing.assert_array_equal(meta[3].numpy() > 0,
                                  setup["alive"].numpy())
    table = port.raster.build_tri_table(screen, tri, t.from_numpy(
        mesh.normals), world)
    np.testing.assert_array_equal(front_table.numpy(), table.numpy())
