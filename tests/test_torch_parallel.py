"""The port's multi-device decompositions (``compute_renderer_torch.
parallel``) on the CPU: gloo groups of spawned ranks, ``device="cpu"``
(the kernels' twins).

One group of four ranks (``world4``) runs every case once; sub-groups of
its first two ranks give the n = 2 cases, and its 2 x 2 layout the 2-D
ones. The contracts:

- against the port's single-device engine (``cuda.render_frame`` at ample
  capacities, ``Renderer``): **bitwise**, RGBA and depth keys, on every
  path (tile stripes, micro stripes, sort-middle), mode (base, materials,
  fused nearest / bilinear / trilinear, deferred trilinear), effect
  (mirage across the seams), SSAA, capacity retry and the tile->micro
  fallback; every rank returns the same frame;
- against the JAX package's ``render_frame_sharded``, ``render_sharded``
  and ``render_frames`` on the 8-virtual-device mesh of tests/conftest.py
  (``tests/test_torch_parallel_ext.py``): the pixel contract of
  tests/test_torch_slice.py, at most max(2, H*W/500) pixels more than 2
  LSB apart (XLA:CPU contracts mul+add into FMA, which flips samples
  exactly on an edge).

Also here: the composite-key (cell, tri) sort against two stable sorts,
``pack_pool_u8`` / ``pixel_grid`` / ``resolve_attributes`` with offsets
against the JAX package (op by op, bitwise), the backend checks, and a
rank that raises.
"""

import time

import numpy as np
import pytest

from tests.torch_parity import cuda_device, port, tpu  # noqa: F401

W, H = 128, 64  # the JAX package's sharding tests' frame
SW, SH = 128, 96  # the small structured build
EYE = (13.566635, 4.0, 24.0)
TIMEOUT_S = 120.0

# (name, mesh, uniforms, options, ranks): the sharded cases of world4.
SHARDED = [
    (f"{scene}_{path}{'' if n == 4 else f'_n{n}'}", mesh, uni, dict(path=path),
     n)
    for scene, mesh, uni in (("plain", "ico", "front"),
                             ("mirage", "cube", "mirage"))
    for path in ("tile", "micro", "sortmiddle")
    for n in ((4, 2) if scene == "plain" else (4,))
] + [
    (f"mat_{path}", "ico_kd", "front", dict(path=path), 4)
    for path in ("tile", "micro", "sortmiddle")
] + [
    (f"{name}_{path}", "structured", "structured",
     dict(path=path, **opts), 4)
    for name, opts in (("texf", {}), ("bilinear", {"tex_filter": "bilinear"}),
                       ("trilinear", {"tex_filter": "trilinear"}),
                       ("deferred_trilinear", {"tex_filter": "trilinear",
                                               "tex_mode": "deferred"}))
    for path in ("tile", "micro", "sortmiddle")
] + [
    (f"ssaa2_{path}", "ico", "front", dict(path=path, ssaa=2), 4)
    for path in ("tile", "micro", "sortmiddle")
] + [
    # Capacities far below the need: render_sharded grows them.
    ("retry_tile", "stack600", "front", dict(path="tile", tile_cap=8), 4),
    ("retry_micro", "ico", "front", dict(path="micro", pair_cap=16), 4),
    ("retry_sortmiddle", "ico", "front",
     dict(path="sortmiddle", pair_cap=16, bucket_cap=8), 4),
    # One tile's list past MAX_TILE_CAP: auto falls back to micro stripes.
    ("fallback_auto", "dense", "front", {}, 4),
]
# One render_frame_sharded call each: its overflow report is the need.
RAW = [
    ("raw_tile_overflow", "stack600", "front", dict(path="tile", tile_cap=8),
     4),
    ("raw_micro_overflow", "ico", "front", dict(path="micro", pair_cap=16),
     4),
    ("raw_sortmiddle_overflow", "ico", "front",
     dict(path="sortmiddle", pair_cap=16, bucket_cap=8), 4),
    ("raw_texf_packed", "structured", "structured",
     dict(path="micro", pack_texels=True), 4),
]
# (name, kind, mesh, uniforms, options): frame-parallel and 2-D cases;
# five frames each (padded to the group).
FRAMES = [
    ("frames_tile", "frames", "ico", "wave", {}),
    ("frames_micro_retry", "frames", "ico", "wave",
     dict(path="micro", pair_cap=512)),
    ("frames_mat", "frames", "ico_kd", "wave", {}),
    ("frames_texf", "frames", "structured", "structured", {}),
    ("frames_fallback", "frames", "dense", "front", {}),
    ("frames2d", "frames2d", "ico", "wave", dict(path="micro")),
    ("frames2d_retry_ssaa", "frames2d", "ico", "wave",
     dict(path="micro", pair_cap=512, ssaa=2)),
]


def _uniforms(port, kind, t=0.0, width=W, height=H):
    """A frame's uniforms as a dict of numpy arrays."""
    eff = port.effects
    if kind == "structured":
        cam = port.camera.Camera.first_person(list(EYE),
                                              aspect=width / height)
        lights = (np.array([[0.0, 0.0, 0.0], [-5.0, 3.0, 0.0]], np.float32),
                  np.array([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5]], np.float32),
                  np.array([1.0, 0.5], np.float32))
    else:
        cam = port.camera.Camera.first_person([0, 0, 3.0],
                                              aspect=width / height)
        lights = (np.array([[0, 0, 5.0]], np.float32),
                  np.ones((1, 3), np.float32), np.ones((1,), np.float32))
    effect = eff.EffectUniform().as_array()
    if kind == "mirage":
        e = eff.Effect.mirage(1.5, 0.5, 1.0)
        e.update(0.4)
        effect = e.uniform(0.4).as_array()
    elif kind == "wave":
        e = eff.Effect.wave(0.3, 2.0, 1.5, eff.WaveDirection.VERTICAL)
        e.update(t)
        effect = e.uniform(t).as_array()
    u = cam.uniform()
    return dict(view_position=u.view_position, view_proj=u.view_proj,
                light_world_pos=lights[0], light_color=lights[1],
                light_intensity=lights[2], effect=effect)


def _dense_mesh(port, n):
    """``n`` stacked, jittered triangles in one screen tile (the JAX
    package's tests/test_sharding_ext.py ``_dense_tile_mesh``): a tile
    list past any legal tile cap at a small triangle count."""
    base = port.procedural.single_triangle(z=0.0)
    pos = np.tile(base.positions, (n, 1))
    pos[:, 2] += np.repeat(np.linspace(0, 0.5, n), 3)
    k = np.repeat(np.arange(n, dtype=np.float64), 3)
    pos[:, 0] += (((k * 0.6180339887) % 1.0) - 0.5) * 0.02
    pos[:, 1] += (((k * 0.7548776662) % 1.0) - 0.5) * 0.02
    return port.convert.mesh_from_arrays(
        pos, np.tile(base.normals, (n, 1)), np.tile(base.uvs, (n, 1)),
        np.arange(3 * n, dtype=np.uint32))


def small_structured(directory):
    """The small structured build of tests/test_torch_ext.py (5,362
    triangles, materials and two map_Kd images) written to
    ``directory`` and loaded with its textures."""
    from compute_renderer_torch.io import objgen
    from compute_renderer_torch.io.obj import load_obj

    objgen.write_structured_obj(directory / "s.obj", terrain_n=40,
                                statue_nu=40, statue_nv=24, ruins=20,
                                mtl_text=objgen._STRUCTURED_MTL)
    objgen._write_shared_textures(directory)
    return load_obj(directory / "s.obj", textures=True)


@pytest.fixture(scope="module")
def scenes(port, tmp_path_factory):
    """The meshes (port ``Mesh``) of the cases: icosphere(2), the same
    with seeded per-face kd, a cube, the dense stacks (past
    ``MAX_TILE_CAP``, and 600 deep: past a first tile cap), and the small
    structured build with its textures and materials."""
    ico = port.procedural.icosphere(2)
    rng = np.random.default_rng(1234)
    kd = rng.uniform(0.2, 1.0, (ico.num_triangles, 3)).astype(np.float32)
    return {
        "ico": ico,
        "ico_kd": port.convert.mesh_from_arrays(
            ico.positions, ico.normals, ico.uvs, ico.indices, face_kd=kd),
        "cube": port.procedural.cube(),
        "dense": _dense_mesh(port, port.cuda.MAX_TILE_CAP + 300),
        "stack600": _dense_mesh(port, 600),
        "structured": small_structured(tmp_path_factory.mktemp("s")),
    }


def _size(mesh_name):
    return (SW, SH) if mesh_name == "structured" else (W, H)


def _frame_seq(port, uni, mesh_name):
    w, h = _size(mesh_name)
    return [_uniforms(port, uni, t=0.1 * i, width=w, height=h)
            for i in range(5)]


@pytest.fixture(scope="module")
def world4(port, scenes):
    """Every case, run once by a gloo group of four CPU ranks: a list of
    each rank's {case name: result}."""
    from compute_renderer_torch.parallel import mesh_tensors
    from tests.torch_parallel_ranks import run_cases

    cases = []
    for raw, specs in ((False, SHARDED), (True, RAW)):
        for name, mesh, uni, options, ranks in specs:
            w, h = _size(mesh)
            cases.append(dict(kind="sharded", raw=raw, name=name, mesh=mesh,
                              uniforms=_uniforms(port, uni, width=w,
                                                 height=h),
                              width=w, height=h, options=options,
                              ranks=ranks))
    for name, kind, mesh, uni, options in FRAMES:
        w, h = _size(mesh)
        cases.append(dict(kind=kind, name=name, mesh=mesh, width=w, height=h,
                          frames=_frame_seq(port, uni, mesh),
                          options=options))
    from compute_renderer_torch.parallel import launch

    meshes = {k: mesh_tensors(m) for k, m in scenes.items()}
    return launch(run_cases, 4, (meshes, cases), device="cpu",
                  timeout=TIMEOUT_S)


def _single(port, mesh, uni, width, height, path="auto", ssaa=1,
            tex_filter="nearest", tex_mode="fused", texels_packed=None):
    """The single-device engine's frame: (rgba (height, width, 4), keys
    (height * ssaa, width * ssaa)) at ample capacities."""
    from compute_renderer_torch.engine.renderer import box_downsample
    from compute_renderer_torch.engine.scene import FrameUniforms

    cuda = port.cuda
    lights = (uni["light_world_pos"], uni["light_color"],
              uni["light_intensity"])
    args, ext = cuda.frame_tensors(mesh, FrameUniforms(**uni), lights,
                                   uni["effect"], "cpu",
                                   tex_filter=tex_filter, tex_mode=tex_mode)
    path = "micro" if path == "sortmiddle" else path
    rgba, keys, overflow = cuda.render_frame(
        *args, width=width * ssaa, height=height * ssaa, path=path,
        pair_cap=1 << 17, tile_cap=cuda.MAX_TILE_CAP, **ext)
    assert not overflow.any()
    return box_downsample(rgba, ssaa).numpy(), keys.numpy()


def _reference(port, scenes, mesh, uni, options):
    opts = {k: v for k, v in options.items()
            if k in ("path", "ssaa", "tex_filter", "tex_mode")}
    if mesh == "dense":
        opts["path"] = "micro"  # where the fallback lands
    w, h = _size(mesh)
    return _single(port, scenes[mesh], _uniforms(port, uni, width=w,
                                                 height=h), w, h, **opts)


def _ranks_agree(world4, name):
    results = [r[name] for r in world4 if name in r]
    for other in results[1:]:
        for a, b in zip(results[0], other):
            np.testing.assert_array_equal(a, b)
    return results


@pytest.mark.parametrize("name,mesh,uni,options,ranks", SHARDED,
                         ids=[c[0] for c in SHARDED])
def test_sharded_equals_single_device(port, scenes, world4, name, mesh, uni,
                                      options, ranks):
    results = _ranks_agree(world4, name)
    assert len(results) == ranks
    rgba, keys = results[0]
    ref_rgba, ref_keys = _reference(port, scenes, mesh, uni, options)
    assert rgba.shape == ref_rgba.shape and rgba.dtype == np.uint8
    np.testing.assert_array_equal(rgba, ref_rgba)
    np.testing.assert_array_equal(keys, ref_keys)
    assert (keys != 0xFFFFFFFF).sum() > 50


def test_modes_show(world4):
    # The mode cases are not the plain frame: materials, textures and
    # filters change the image.
    r = world4[0]
    for a, b in (("mat_tile", "plain_tile"), ("bilinear_micro", "texf_micro"),
                 ("trilinear_micro", "texf_micro")):
        assert (r[a][0] != r[b][0]).any(), (a, b)
    # Fused and deferred trilinear are one image.
    for path in ("tile", "micro", "sortmiddle"):
        np.testing.assert_array_equal(r[f"trilinear_{path}"][0],
                                      r[f"deferred_trilinear_{path}"][0])


# (case, pairs past pair_cap, second entry past its cap): the tile
# stripes bin densely at this size (no pair list), the micro stripes have
# no second cap, sort-middle's is the send bucket.
@pytest.mark.parametrize("name,pairs,second", [
    ("raw_tile_overflow", False, True), ("raw_micro_overflow", True, False),
    ("raw_sortmiddle_overflow", True, True)])
def test_overflow_report_is_the_max_over_ranks(world4, name, pairs, second):
    reports = [r[name][2] for r in world4]
    for rep in reports[1:]:
        np.testing.assert_array_equal(rep, reports[0])
    assert (reports[0][0] > 0) == pairs
    assert (reports[0][1] > 0) == second


def test_packed_pool_equals_f32_pool(port, scenes, world4):
    # texels_packed (io.textures.pack_pool_u8) samples the same texels.
    rgba, keys, overflow = world4[0]["raw_texf_packed"]
    assert not overflow.any()
    np.testing.assert_array_equal(rgba, world4[0]["texf_micro"][0])
    np.testing.assert_array_equal(keys, world4[0]["texf_micro"][1])


@pytest.mark.parametrize("name,kind,mesh,uni,options", FRAMES,
                         ids=[c[0] for c in FRAMES])
def test_frames_equal_single_device(port, scenes, world4, name, kind, mesh,
                                    uni, options):
    from compute_renderer_torch.engine.scene import FrameUniforms

    results = _ranks_agree(world4, name)
    assert len(results) == 4
    frames = results[0]
    w, h = _size(mesh)
    seq = _frame_seq(port, uni, mesh)
    assert frames.shape == (len(seq), h, w, 4)
    single = port.renderer.Renderer(
        scenes[mesh], w, h, device="cpu",
        **{k: v for k, v in options.items() if k != "pair_cap"})
    for i, u in enumerate(seq):
        np.testing.assert_array_equal(frames[i],
                                      single.render(FrameUniforms(**u)))
    assert (frames[0] != frames[-1]).any() or uni != "wave"


def test_sort_cell_tri_equals_two_stable_sorts(port):
    from compute_renderer_torch.parallel.sharding import sort_cell_tri

    torch = port.torch
    rng = np.random.default_rng(7)
    cell = rng.integers(0, 50, 4000).astype(np.int32)
    tri = rng.integers(0, 3000, 4000).astype(np.int32)
    cell[::7] = 50  # empty slots: (num_cells, 0), identical rows
    tri[::7] = 0
    c, t = sort_cell_tri(torch.from_numpy(cell), torch.from_numpy(tri), 3000)
    # Two stable sorts: by the minor key, then by the major one.
    o1 = torch.sort(torch.from_numpy(tri), stable=True).indices
    o2 = torch.sort(torch.from_numpy(cell)[o1], stable=True).indices
    order = o1[o2]
    np.testing.assert_array_equal(c.numpy(), cell[order.numpy()])
    np.testing.assert_array_equal(t.numpy(), tri[order.numpy()])
    lex = np.lexsort((tri, cell))
    np.testing.assert_array_equal(c.numpy(), cell[lex])
    np.testing.assert_array_equal(t.numpy(), tri[lex])


def test_pack_pool_u8_vs_jax(port, tpu, scenes):
    from compute_renderer_torch.io.textures import pack_pool_u8
    from compute_renderer_tpu.io.textures import pack_pool_u8 as jax_pack

    texels = scenes["structured"].texels
    a, b = jax_pack(texels), pack_pool_u8(texels)
    assert a is not None and a.dtype == b.dtype == np.int32
    np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(3)
    off = rng.uniform(0, 1, (64, 3)).astype(np.float32)  # not u8 values
    assert jax_pack(off) is None and pack_pool_u8(off) is None
    assert pack_pool_u8(np.zeros((0, 3), np.float32)) is None


def test_fused_tail_packed_vs_jax(port, tpu):
    # The packed fetch against the JAX package's, op by op, and against
    # the f32 pool: bitwise.
    from compute_renderer_torch.io.textures import pack_pool_u8

    rng = np.random.default_rng(11)
    texels = (rng.integers(0, 256, (256, 3)) / np.float32(255.0)).astype(
        np.float32)
    packed = pack_pool_u8(texels)
    h, w, L = 16, 24, 2
    gbuf = np.zeros((8 + 2 * L, h, w), np.float32)
    gbuf[0:2] = rng.uniform(-2, 2, (2, h, w))
    gbuf[2:5] = rng.uniform(0, 1, (3, h, w))
    gbuf[5] = 0.0
    gbuf[6] = 16.0
    gbuf[7] = 16.0
    gbuf[8:] = rng.uniform(0, 1, (2 * L, h, w))
    key = rng.integers(0, 2**31, (h, w)).astype(np.uint32)
    key[::3, ::5] = 0xFFFFFFFF
    lc = np.array([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5]], np.float32)
    li = np.array([1.0, 0.5], np.float32)
    t, jnp = port.torch, tpu.jnp
    for tex_filter in ("nearest", "bilinear"):
        with tpu.jax.disable_jit():
            a = tpu.common.fused_texture_tail(
                jnp.asarray(gbuf), jnp.asarray(key), jnp.asarray(texels),
                jnp.asarray(lc), jnp.asarray(li), tex_filter=tex_filter,
                texels_packed=jnp.asarray(packed))
        b = port.common.fused_texture_tail(
            t.from_numpy(gbuf), t.from_numpy(key.view(np.int32)),
            t.from_numpy(texels), t.from_numpy(lc), t.from_numpy(li),
            tex_filter=tex_filter, texels_packed=t.from_numpy(packed))
        c = port.common.fused_texture_tail(
            t.from_numpy(gbuf), t.from_numpy(key.view(np.int32)),
            t.from_numpy(texels), t.from_numpy(lc), t.from_numpy(li),
            tex_filter=tex_filter)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
        np.testing.assert_array_equal(b.numpy(), c.numpy())


@pytest.mark.parametrize("effect", ["none", "mirage"])
def test_pixel_grid_and_resolve_with_offsets_vs_jax(port, tpu, scenes,
                                                    effect):
    # A window of the frame at (x_offset, y_offset), op by op: bitwise.
    t, jnp = port.torch, tpu.jnp
    mesh = scenes["ico"]
    uni = _uniforms(port, "mirage" if effect == "mirage" else "front")
    eff = uni["effect"]
    x_off, y_off, w, h = 40, 24, 48, 16
    with tpu.jax.disable_jit():
        ja = tpu.common.pixel_grid(jnp.asarray(eff), w, h, x_off, y_off)
    pa = port.common.pixel_grid(t.from_numpy(eff), w, h, x_off, y_off)
    for a, b in zip(ja, pa):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    full = port.common.pixel_grid(t.from_numpy(eff), W, H)
    for a, b in zip(full, pa):
        np.testing.assert_array_equal(
            a[y_off:y_off + h, x_off:x_off + w].numpy(), b.numpy())
    # resolve_attributes: random winners over the mesh's triangles.
    tri = mesh.indices.astype(np.int32).reshape(-1, 3)
    world, screen = port.common.vertex_stage(
        t.from_numpy(mesh.positions), t.from_numpy(uni["view_proj"]),
        t.from_numpy(eff), W, H)
    rng = np.random.default_rng(5)
    best = rng.integers(-1, tri.shape[0], (h, w)).astype(np.int32)
    with tpu.jax.disable_jit():
        ga = tpu.common.resolve_attributes(
            jnp.asarray(best), jnp.asarray(tri), jnp.asarray(screen.numpy()),
            jnp.asarray(world.numpy()), jnp.asarray(mesh.normals),
            jnp.asarray(mesh.uvs), jnp.asarray(eff), w, h, x_off, y_off)
    gb = port.common.resolve_attributes(
        t.from_numpy(best), t.from_numpy(tri), screen, world,
        t.from_numpy(mesh.normals), t.from_numpy(mesh.uvs),
        t.from_numpy(eff), w, h, x_off, y_off)
    np.testing.assert_array_equal(np.asarray(ga["flag"]), gb["flag"].numpy())
    for k in ("uv", "normal", "world_pos"):
        np.testing.assert_array_equal(
            np.asarray(ga[k]).view(np.int32), gb[k].numpy().view(np.int32))


def test_backend_checks(port):
    from compute_renderer_torch.parallel import group, sharding

    with pytest.raises(ValueError, match="unknown backend"):
        group.check_backend("mpi", 2, "cpu")
    with pytest.raises(ValueError, match="needs device 'cuda'"):
        group.check_backend("nccl", 1, "cpu")
    with pytest.raises(ValueError, match="ssaa=3"):
        sharding._check_ssaa_stripes(3, stripe_h=8, padded_w=128)
    sharding._check_ssaa_stripes(2, stripe_h=8, padded_w=128)
    group.check_backend("gloo", 8, "cpu")
    if not port.torch.cuda.is_available():
        with pytest.raises(ValueError, match="one rank a GPU"):
            group.check_backend("nccl", 1, "cuda")
        with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
            group.rank_device("cuda", 0)


def test_init_defaults_to_the_card(port, tmp_path):
    # init runs on the card unless the caller asks for the CPU, as launch
    # does: without a card it raises before it joins any group.
    import torch.distributed as dist

    from compute_renderer_torch.parallel import group

    if port.torch.cuda.is_available():
        pytest.skip("a card is present: init joins on it")
    with pytest.raises(RuntimeError, match="needs an NVIDIA GPU"):
        group.init("gloo", 0, 1, f"file://{tmp_path}/store")
    assert not dist.is_initialized()


def test_failing_rank_raises_in_parent(port):
    from compute_renderer_torch.parallel import launch
    from tests.torch_parallel_ranks import fail_on_rank_one

    # Rank 0 waits in a barrier for rank 1, which raises: the parent raises
    # with the first rank's error to end (rank 1's, or rank 0's barrier
    # losing its peer), well inside the group's timeout.
    timeout = 60.0
    t0 = time.perf_counter()
    with pytest.raises(port.torch.multiprocessing.ProcessRaisedException,
                       match="rank 1 fails on purpose|by peer"):
        launch(fail_on_rank_one, 2, device="cpu", timeout=timeout)
    assert time.perf_counter() - t0 < timeout / 2


@pytest.mark.cuda
def test_stripes_on_card(port, scenes, cuda_device):
    # Two gloo ranks sharing the card: every path's frame and keys equal
    # the single-device engine's on the card, bitwise.
    from compute_renderer_torch.engine.scene import FrameUniforms
    from compute_renderer_torch.parallel import launch, mesh_tensors
    from tests.torch_parallel_ranks import run_cases

    cases = [dict(kind="sharded", name=p, mesh="ico", width=W, height=H,
                  uniforms=_uniforms(port, "mirage"), options=dict(path=p),
                  device="cuda")
             for p in ("tile", "micro", "sortmiddle")]
    res = launch(run_cases, 2, ({"ico": mesh_tensors(scenes["ico"])}, cases),
                 device="cuda", timeout=TIMEOUT_S)
    cuda = port.cuda
    u = _uniforms(port, "mirage")
    lights = (u["light_world_pos"], u["light_color"], u["light_intensity"])
    args, ext = cuda.frame_tensors(scenes["ico"], FrameUniforms(**u), lights,
                                   u["effect"], cuda_device)
    for p in ("tile", "micro", "sortmiddle"):
        rgba, keys, _ = cuda.render_frame(
            *args, width=W, height=H, path="micro" if p == "sortmiddle" else p,
            pair_cap=1 << 17, **ext)
        for r in res:
            np.testing.assert_array_equal(r[p][0], rgba.cpu().numpy())
            np.testing.assert_array_equal(r[p][1], keys.cpu().numpy())
