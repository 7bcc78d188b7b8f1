"""The whole slice: the port's ``Renderer`` against the JAX package's
``Renderer(backend="tpu")`` on the CPU (Pallas in interpret mode).

Pixel contract (tests/test_front_kernel.py:336-340): at most
max(2, H*W/500) pixels differ by more than 2 LSB — XLA:CPU contracts
mul+add into FMA, which flips samples exactly on an edge."""

import os

import numpy as np
import pytest

from tests.torch_parity import (  # noqa: F401 (fixtures)
    assert_frames_match, cuda_device, port, tpu,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "golden_data",
                      "torch_slice_suzanne_1024x768.npz")
DT = 1.0 / 60.0


def _bench_scenes(port, tpu, model="suzanne.obj", width=1024, height=768,
                  effect=None):
    """bench.py's scene (first-person camera at (0, 0, 3), default
    lights) in both packages."""
    out = []
    for pkg in (tpu, port):
        cc = pkg.scene.CameraConfig(
            distance=2.0, mode=pkg.camera.CameraMode.FIRST_PERSON,
            position=(0.0, 0.0, 3.0))
        eff = effect(pkg) if effect else None
        cfg = pkg.scene.SceneConfig(model_path=model, camera_config=cc,
                                    effect=eff)
        out.append(pkg.scene.Scene.from_config(cfg, width, height))
    return out


def test_bench_config_three_frames(port, tpu):
    js, ts = _bench_scenes(port, tpu)
    jr = tpu.renderer.Renderer(js.mesh, 1024, 768, backend="tpu",
                               **js.renderer_options())
    tr = port.renderer.Renderer(ts.mesh, 1024, 768, device="cpu",
                                **ts.renderer_options())
    for _ in range(3):
        a = jr.render(js.update(DT))
        b = tr.render(ts.update(DT))
        assert b.shape == (768, 1024, 4) and b.dtype == np.uint8
        assert_frames_match(a, b)
    covered = (b != np.array([0, 0, 255, 255], np.uint8)).any(axis=-1)
    assert covered.sum() > 50_000


def test_golden_frames_match(port):
    # The golden file (scripts/make_torch_slice_golden.py) is what
    # chip_smoke.py holds the card's frames against.
    golden = np.load(GOLDEN)["rgba"]
    assert golden.shape == (3, 768, 1024, 4)
    cc = port.scene.CameraConfig(
        distance=2.0, mode=port.camera.CameraMode.FIRST_PERSON,
        position=(0.0, 0.0, 3.0))
    ts = port.scene.Scene.from_config(
        port.scene.SceneConfig(model_path="suzanne.obj", camera_config=cc),
        1024, 768)
    tr = port.renderer.Renderer(ts.mesh, 1024, 768, device="cpu",
                                **ts.renderer_options())
    for i in range(3):
        assert_frames_match(golden[i], tr.render(ts.update(DT)))


def test_san_miguel_small_flat_layout(port, tpu):
    W, H = 256, 192
    js, ts = _bench_scenes(port, tpu, "san_miguel_small.obj", W, H)
    jr = tpu.renderer.Renderer(js.mesh, W, H, backend="tpu",
                               **js.renderer_options())
    tr = port.renderer.Renderer(ts.mesh, W, H, device="cpu",
                                **ts.renderer_options())
    u_j, u_t = js.update(DT), ts.update(DT)
    assert_frames_match(jr.render(u_j), tr.render(u_t))
    # The scene takes the sort (flat) binning layout at this size.
    caps = port.cuda.default_caps("tile", ts.mesh.num_triangles, W, H)
    ntx, nty = 1, 12
    assert (ntx * nty * caps["tile_cap"] * ts.mesh.num_triangles
            > port.binning.DENSE_BINNING_OP_LIMIT)


def test_wave_frame(port, tpu):
    W, H = 512, 384

    def wave(pkg):
        return pkg.effects.Effect.wave(0.3, 4.0, 2.0,
                                       pkg.effects.WaveDirection.RADIAL)

    js, ts = _bench_scenes(port, tpu, "suzanne.obj", W, H, effect=wave)
    jr = tpu.renderer.Renderer(js.mesh, W, H, backend="tpu",
                               **js.renderer_options())
    tr = port.renderer.Renderer(ts.mesh, W, H, device="cpu",
                                **ts.renderer_options())
    for _ in range(2):
        assert_frames_match(jr.render(js.update(0.1)),
                            tr.render(ts.update(0.1)))


def _stacked_triangles(procedural, convert, n=200):
    base = procedural.single_triangle(z=0.0)
    pos = np.tile(base.positions, (n, 1))
    pos[:, 2] += np.repeat(np.linspace(0, 0.5, n), 3)  # distinct depths
    return convert.mesh_from_arrays(pos, np.tile(base.normals, (n, 1)),
                                    np.tile(base.uvs, (n, 1)),
                                    np.arange(3 * n, dtype=np.uint32))


def _uniforms(port, W, H):
    cam = port.camera.Camera.first_person([0, 0, 3.0], aspect=W / H)
    u = cam.uniform()
    return port.convert.uniforms_from_arrays(
        u.view_position, u.view_proj, [[0.0, 0.0, 5.0]], [[1.0, 0.9, 0.8]],
        [1.0], [0, 0, 0, 0, 0, 0])


def test_overflow_retry(port, tpu):
    # 200 coincident triangles in one tile against tile_cap=96: the engine
    # must detect the overflow and retry at the reported need, as
    # tests/test_tpu_backend.py:167-203 checks for the JAX package.
    W, H = 256, 192
    mesh = _stacked_triangles(port.procedural, port.convert)
    uniforms = _uniforms(port, W, H)
    r = port.renderer.Renderer(mesh, W, H, device="cpu", tile_cap=96)
    img = r.render(uniforms)
    assert r.options["tile_cap"] >= 200
    assert (img[..., 0] > 0).any()
    r2 = port.renderer.Renderer(mesh, W, H, device="cpu", tile_cap=1024)
    np.testing.assert_array_equal(img, r2.render(uniforms))
    jr = tpu.renderer.Renderer(mesh, W, H, backend="tpu", tile_cap=96)
    assert_frames_match(jr.render(uniforms), img)
    assert jr.options["tile_cap"] == r.options["tile_cap"]


def test_batch_unchecked_overflow_is_flushed(port):
    W, H = 256, 192
    mesh = _stacked_triangles(port.procedural, port.convert)
    uniforms = _uniforms(port, W, H)
    r = port.renderer.Renderer(mesh, W, H, device="cpu", tile_cap=96)
    frames = r.render_batch_device([uniforms] * 2, check=False)
    assert frames.shape == (2, H, W, 4)
    r.fence_pending()
    assert r.flush_overflow()  # dropped triangles are reported
    assert not r.flush_overflow()  # and cleared
    frames = r.render_batch_device([uniforms] * 2)  # checked: retries
    assert r.options["tile_cap"] >= 200 and not r.flush_overflow()
    np.testing.assert_array_equal(frames[0].numpy(), r.render(uniforms))


def test_chunked_depth_merge_matches_single_pass(port, tpu):
    # path="tile" with a tiny tri_chunk renders in triangle chunks merged by
    # depth key: the same image as one pass, and as the JAX package's.
    W, H = 256, 192
    js, ts = _bench_scenes(port, tpu, "suzanne.obj", W, H)
    u = ts.update(DT)
    single = port.renderer.Renderer(ts.mesh, W, H, device="cpu")
    chunked = port.renderer.Renderer(ts.mesh, W, H, device="cpu",
                                     path="tile", tri_chunk=300)
    a = single.render_device(u)
    b = chunked.render_device(u)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    np.testing.assert_array_equal(a[1].numpy(), b[1].numpy())
    jr = tpu.renderer.Renderer(js.mesh, W, H, backend="tpu", path="tile",
                               tri_chunk=300)
    assert_frames_match(jr.render(js.update(DT)), b[0].numpy())


def test_host_level_render_retries(port, tpu):
    # cuda.render, the host-level entry with capacity retry, against the
    # JAX package's tpu.render on the same mesh and uniforms.
    W, H = 256, 192
    mesh = _stacked_triangles(port.procedural, port.convert)
    cam = port.camera.Camera.first_person([0, 0, 3.0], aspect=W / H)
    lights = (np.array([[0.0, 0.0, 5.0]], np.float32),
              np.array([[1.0, 0.9, 0.8]], np.float32),
              np.array([1.0], np.float32))
    eff = np.zeros(6, np.float32)
    a = tpu.backend.render(mesh, cam.uniform(), lights, eff, W, H,
                           tile_cap=96)
    b = port.cuda.render(mesh, cam.uniform(), lights, eff, W, H,
                         device="cpu", tile_cap=96)
    assert_frames_match(a, b)


def test_box_downsample_and_ssaa(port, tpu):
    rng = np.random.default_rng(5)
    img = rng.integers(0, 256, (12, 18, 4), dtype=np.uint8)
    a = np.asarray(tpu.renderer.box_downsample(tpu.jnp.asarray(img), 3))
    b = port.renderer.box_downsample(port.torch.from_numpy(img), 3).numpy()
    np.testing.assert_array_equal(a, b)
    js, ts = _bench_scenes(port, tpu, "suzanne.obj", 128, 96)
    tr = port.renderer.Renderer(ts.mesh, 128, 96, device="cpu", ssaa=2)
    jr = tpu.renderer.Renderer(js.mesh, 128, 96, backend="tpu", ssaa=2)
    assert_frames_match(jr.render(js.update(DT)), tr.render(ts.update(DT)))


def test_empty_mesh_renders_background(port, tpu):
    W, H = 64, 48
    empty = port.convert.mesh_from_arrays(np.zeros((0, 3)), np.zeros((0, 3)),
                                          np.zeros((0, 2)), np.zeros((0,)))
    uniforms = _uniforms(port, W, H)
    img = port.renderer.Renderer(empty, W, H, device="cpu").render(uniforms)
    ref = tpu.renderer.Renderer(empty, W, H, backend="tpu").render(uniforms)
    np.testing.assert_array_equal(img, ref)
    assert (img == np.array([0, 0, 255, 255], np.uint8)).all()


def test_unported_paths_raise(port):
    mesh = port.procedural.make_model("suzanne.obj")
    # The micro path is ported: forcing it renders the same frame as the
    # tile path within the pixel contract.
    cam = port.camera.Camera.first_person([0, 0, 3.0], aspect=1.0).uniform()
    uniforms = port.convert.uniforms_from_arrays(
        cam.view_position, cam.view_proj, [[0.0, 0.0, 5.0]],
        [[1.0, 0.9, 0.8]], [1.0], [0, 0, 0, 0, 0, 0])
    micro = port.renderer.Renderer(mesh, 64, 64, device="cpu", path="micro")
    tile = port.renderer.Renderer(mesh, 64, 64, device="cpu")
    img = micro.render(uniforms)
    assert (img != np.array([0, 0, 255, 255], np.uint8)).any(axis=-1).sum() \
        > 300
    assert_frames_match(tile.render(uniforms), img)
    # The comparators are ported too: xla renders the engine's frame bit
    # for bit, "tpu" (the JAX package's name) is the engine, and an
    # unknown backend raises.
    for backend in ("xla", "tpu"):
        np.testing.assert_array_equal(
            port.renderer.Renderer(mesh, 64, 64, backend,
                                   device="cpu").render(uniforms),
            tile.render(uniforms))
    with pytest.raises(ValueError):
        port.renderer.Renderer(mesh, 64, 64, "vulkan", device="cpu")
    # Every material and texture mode is ported: a white 1x1 texture
    # modulates nothing, in any of them.
    kd = port.convert.mesh_from_arrays(
        mesh.positions, mesh.normals, mesh.uvs, mesh.indices,
        face_kd=np.ones((mesh.num_triangles, 3), np.float32))
    assert_frames_match(tile.render(uniforms), port.renderer.Renderer(
        kd, 64, 64, device="cpu").render(uniforms))
    textured = port.convert.mesh_from_arrays(
        mesh.positions, mesh.normals, mesh.uvs, mesh.indices,
        face_tex=np.zeros(mesh.num_triangles, np.int32),
        texels=np.ones((1, 3), np.float32), tex_table=[[0, 1, 1]])
    for opts in ({"tex_filter": "trilinear"}, {"tex_filter": "anisotropic"},
                 {"tex_mode": "deferred"}):
        assert_frames_match(tile.render(uniforms), port.renderer.Renderer(
            textured, 64, 64, device="cpu", **opts).render(uniforms))
    with pytest.raises(ValueError):
        port.renderer.Renderer(mesh, 64, 64, device="cpu", tex_filter="cubic")


def test_device_is_explicit(port, monkeypatch):
    # The entry points run on the card unless the caller asks for the CPU:
    # the default is "cuda", which raises on a machine without a card
    # instead of running the twins; device="cpu" selects the twins.
    import inspect

    mesh = port.procedural.make_model("suzanne.obj")
    for fn in (port.renderer.Renderer.__init__, port.cuda.render):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(port.torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.renderer.Renderer(mesh, 64, 48)
    cam = port.camera.Camera.first_person([0, 0, 3.0], aspect=64 / 48)
    lights = (np.zeros((1, 3), np.float32), np.ones((1, 3), np.float32),
              np.ones(1, np.float32))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port.cuda.render(mesh, cam.uniform(), lights, np.zeros(6, np.float32),
                         64, 48)
    r = port.renderer.Renderer(mesh, 64, 48, device="cpu")
    assert r.device.type == "cpu" and r.pos_soa.device.type == "cpu"


@pytest.mark.cuda
def test_bench_config_on_card(port, cuda_device):
    golden = np.load(GOLDEN)["rgba"]
    cc = port.scene.CameraConfig(
        distance=2.0, mode=port.camera.CameraMode.FIRST_PERSON,
        position=(0.0, 0.0, 3.0))
    ts = port.scene.Scene.from_config(
        port.scene.SceneConfig(model_path="suzanne.obj", camera_config=cc),
        1024, 768)
    r = port.renderer.Renderer(ts.mesh, 1024, 768, device=cuda_device,
                               **ts.renderer_options())
    port.tracing.reset()
    for i in range(3):
        assert_frames_match(golden[i], r.render(ts.update(DT)))
    # The first frame tunes the tile shape: each candidate's graph is
    # captured once (an eager warm-up and the capture tick the counters);
    # every frame then replays the winner's graph, which ticks nothing.
    captures = 2 * len(port.cuda.TILE_CANDIDATES)
    assert port.tracing.count("launches.front_end") == captures
    assert port.tracing.count("launches.raster_shade_tiles") == captures
