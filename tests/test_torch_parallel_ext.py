"""The port's multi-device decompositions against the JAX package's, and
the JAX package's multi-device dry run replayed on eight ranks.

A gloo group of eight CPU ranks (``world8``, ``device="cpu"``) renders:

- the inputs of ``__graft_entry__.dryrun_multichip`` (icosphere(2) at
  256x128, two lights, first person at (0, 0, 3)): tile, micro and
  sort-middle stripes, eight frame-parallel frames, and the 2 x 4 frames
  x stripes layout. MULTICHIP_r05.json records 1,581 covered pixels on
  each path of the JAX run; the port's must be the same count, and every
  decomposition the port's single-device frame, bitwise;
- the JAX package's own cases (tests/test_sharding.py: icosphere(2) at
  128x64, one light at (0, 0, 5)) on each path and frame-parallel, and
  the small structured build's bilinear tile stripes and deferred
  trilinear sort-middle at 128x96, held to the JAX package's
  ``render_frame_sharded``, ``render_sharded`` and ``render_frames`` on
  the 8-virtual-device mesh (tests/conftest.py)
  within the pixel contract of tests/test_torch_slice.py: at most
  max(2, H*W/500) pixels more than 2 LSB apart (XLA:CPU contracts
  mul+add into FMA, which flips samples exactly on an edge), and the
  covered pixel counts within the same budget.
"""

import numpy as np
import pytest

from tests.torch_parity import (  # noqa: F401 (fixtures)
    assert_frames_match, pixel_budget, port, tpu,
)
from tests.test_torch_parallel import (
    SH, SW, W, H, _single, _uniforms, small_structured,
)

DW, DH = 256, 128  # dryrun_multichip's frame at eight devices
DRYRUN_COVERED = 1581  # MULTICHIP_r05.json
TIMEOUT_S = 120.0


def _dryrun_uniforms(port):
    cam = port.camera.Camera.first_person([0.0, 0.0, 3.0], aspect=DW / DH)
    u = cam.uniform()
    return dict(
        view_position=u.view_position, view_proj=u.view_proj,
        light_world_pos=np.array([[0.0, 0.0, 0.0], [-5.0, 3.0, 0.0]],
                                 np.float32),
        light_color=np.array([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5]],
                             np.float32),
        light_intensity=np.array([1.0, 0.5], np.float32),
        effect=port.effects.EffectUniform().as_array())


@pytest.fixture(scope="module")
def structured(port, tmp_path_factory):
    """The small structured build, textured."""
    return small_structured(tmp_path_factory.mktemp("s"))


# (name, options) of the textured cases held to the JAX package.
TEXTURED = [("jax_bilinear_tile", dict(path="tile", tex_filter="bilinear")),
            ("jax_deferred_trilinear_sortmiddle",
             dict(path="sortmiddle", tex_filter="trilinear",
                  tex_mode="deferred"))]


@pytest.fixture(scope="module")
def world8(port, structured):
    """The cases, run once by a gloo group of eight CPU ranks."""
    from compute_renderer_torch.parallel import launch
    from compute_renderer_torch.parallel import mesh_tensors
    from tests.torch_parallel_ranks import run_cases

    meshes = {"ico": mesh_tensors(port.procedural.icosphere(2)),
              "structured": mesh_tensors(structured)}
    dry, plain = _dryrun_uniforms(port), _uniforms(port, "front")
    tex = _uniforms(port, "structured", width=SW, height=SH)
    cases = [dict(kind="sharded", name=f"dryrun_{p}", mesh="ico",
                  uniforms=dry, width=DW, height=DH, options=dict(path=p))
             for p in ("tile", "micro", "sortmiddle")]
    cases += [dict(kind="sharded", name=f"jax_{p}", mesh="ico",
                   uniforms=plain, width=W, height=H, options=dict(path=p))
              for p in ("tile", "micro", "sortmiddle")]
    cases += [dict(kind="sharded", name=name, mesh="structured",
                   uniforms=tex, width=SW, height=SH, options=options)
              for name, options in TEXTURED]
    cases += [
        dict(kind="frames", name="dryrun_frames", mesh="ico", width=DW,
             height=DH, frames=[dry] * 8),
        dict(kind="frames2d", name="dryrun_frames2d", mesh="ico", width=DW,
             height=DH, frames=[dry] * 2, options=dict(path="micro")),
        dict(kind="frames", name="jax_frames", mesh="ico", width=W,
             height=H, frames=[plain] * 3),
    ]
    return launch(run_cases, 8, (meshes, cases), device="cpu",
                  timeout=TIMEOUT_S)


@pytest.mark.parametrize("path", ["tile", "micro", "sortmiddle"])
def test_dryrun_covered_pixels(port, world8, path):
    rgba, keys = world8[0][f"dryrun_{path}"]
    assert rgba.shape == (DH, DW, 4) and keys.shape == (DH, DW)
    assert int((keys != 0xFFFFFFFF).sum()) == DRYRUN_COVERED
    ref_rgba, ref_keys = _single(port, port.procedural.icosphere(2),
                                 _dryrun_uniforms(port), DW, DH, path=path)
    np.testing.assert_array_equal(rgba, ref_rgba)
    np.testing.assert_array_equal(keys, ref_keys)
    for r in world8[1:]:
        np.testing.assert_array_equal(r[f"dryrun_{path}"][0], rgba)


def test_dryrun_frames_and_2d_layout(port, world8):
    from compute_renderer_torch.engine.renderer import Renderer
    from compute_renderer_torch.engine.scene import FrameUniforms

    mesh = port.procedural.icosphere(2)
    uni = FrameUniforms(**_dryrun_uniforms(port))
    frames = world8[0]["dryrun_frames"]
    assert frames.shape == (8, DH, DW, 4)
    single = Renderer(mesh, DW, DH, device="cpu").render(uni)
    for f in frames:
        np.testing.assert_array_equal(f, single)
    frames2d = world8[0]["dryrun_frames2d"]
    assert frames2d.shape == (2, DH, DW, 4)
    micro = Renderer(mesh, DW, DH, device="cpu", path="micro").render(uni)
    for f in frames2d:
        np.testing.assert_array_equal(f, micro)
    for r in world8[1:]:
        np.testing.assert_array_equal(r["dryrun_frames2d"], frames2d)


def test_make_2d_layout_2x4(port):
    # The 2 x 4 layout's groups, as the dry run builds them: ranks f*4 + t.
    from compute_renderer_torch.parallel import launch
    from tests.torch_parallel_ranks import layout_ranks

    layouts = launch(layout_ranks, 8, (2, 4), device="cpu",
                     timeout=TIMEOUT_S)
    for rank, (f, t, stripes, frames) in enumerate(layouts):
        assert (f, t) == (rank // 4, rank % 4)
        assert stripes == [f * 4 + i for i in range(4)]
        assert frames == [i * 4 + t for i in range(2)]


def _jax_args(tpu, port):
    jnp = tpu.jnp
    mesh = tpu.procedural.icosphere(2)
    u = _uniforms(port, "front")
    return (jnp.asarray(mesh.positions), jnp.asarray(mesh.normals),
            jnp.asarray(mesh.uvs),
            jnp.asarray(mesh.indices.astype(np.int32)).reshape(-1, 3),
            jnp.asarray(u["view_proj"]), jnp.asarray(u["view_position"]),
            jnp.asarray(u["light_world_pos"]), jnp.asarray(u["light_color"]),
            jnp.asarray(u["light_intensity"]), jnp.asarray(u["effect"]))


@pytest.fixture(scope="module")
def mesh8(tpu):
    from compute_renderer_tpu.parallel.sharding import make_mesh

    if len(tpu.jax.devices()) < 8:
        pytest.skip("needs the 8 virtual devices of tests/conftest.py")
    return make_mesh(8)


def _assert_contract(a_rgba, a_keys, b_rgba, b_keys):
    assert_frames_match(a_rgba, b_rgba)
    covered_a = int((np.asarray(a_keys) != 0xFFFFFFFF).sum())
    covered_b = int((np.asarray(b_keys) != 0xFFFFFFFF).sum())
    assert covered_b > 100
    assert abs(covered_a - covered_b) <= pixel_budget(*np.shape(b_keys))


@pytest.mark.parametrize("path", ["tile", "micro", "sortmiddle"])
def test_sharded_vs_jax(port, tpu, world8, mesh8, path):
    from compute_renderer_tpu.parallel.sharding import (
        render_frame_sharded, render_sharded,
    )

    args = _jax_args(tpu, port)
    if path == "tile":
        rgba, keys, overflow = render_frame_sharded(
            *args, mesh=mesh8, width=W, height=H)
        assert not np.asarray(overflow).any()
    else:
        rgba, keys = render_sharded(*args, mesh=mesh8, width=W, height=H,
                                    path=path)
    b_rgba, b_keys = world8[0][f"jax_{path}"]
    _assert_contract(np.asarray(rgba), np.asarray(keys), b_rgba, b_keys)


def test_frames_vs_jax(port, tpu, world8, mesh8):
    from compute_renderer_tpu.engine.renderer import Renderer
    from compute_renderer_tpu.engine.scene import FrameUniforms
    from compute_renderer_tpu.parallel.frames import render_frames

    u = FrameUniforms(**_uniforms(port, "front"))
    r = Renderer(tpu.procedural.icosphere(2), W, H, backend="tpu")
    a = render_frames(r, [u] * 3, mesh8)
    b = world8[0]["jax_frames"]
    assert a.shape == b.shape == (3, H, W, 4)
    for fa, fb in zip(a, b):
        assert_frames_match(fa, fb)


@pytest.mark.parametrize("name,options", TEXTURED,
                         ids=[c[0] for c in TEXTURED])
def test_textured_sharded_vs_jax(port, tpu, world8, mesh8, structured, name,
                                 options):
    # The JAX host entry builds the mip pool from the base atlas.
    from compute_renderer_tpu.parallel.sharding import render_sharded

    jnp, m = tpu.jnp, structured
    u = _uniforms(port, "structured", width=SW, height=SH)
    rgba, keys = render_sharded(
        jnp.asarray(m.positions), jnp.asarray(m.normals), jnp.asarray(m.uvs),
        jnp.asarray(m.indices.astype(np.int32)).reshape(-1, 3),
        jnp.asarray(u["view_proj"]), jnp.asarray(u["view_position"]),
        jnp.asarray(u["light_world_pos"]), jnp.asarray(u["light_color"]),
        jnp.asarray(u["light_intensity"]), jnp.asarray(u["effect"]),
        mesh=mesh8, width=SW, height=SH, face_kd=jnp.asarray(m.face_kd),
        face_tex=jnp.asarray(m.face_tex), texels=jnp.asarray(m.texels),
        tex_table=jnp.asarray(m.tex_table), **options)
    b_rgba, b_keys = world8[0][name]
    _assert_contract(np.asarray(rgba), np.asarray(keys), b_rgba, b_keys)
