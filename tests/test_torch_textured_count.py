"""The mip texture tail's count of the pixels it shades from an image: the
sixth word of a batch's accumulator (``texture.texture_tail_mip``'s
``acc``) and ``tracing.frame_counts()["textured"]``.

On the CPU: the plain count (``texture.textured_pixels_plain``) is the
sampler's ``has`` (covered, and the winner's triangle textured); the tail
adds it to the sixth word alone and its image does not change; a traced
micro batch of the structured scene under trilinear filtering, with a
256-texel ground image so that its 96x72 frames minify, gives
``frame_counts()["textured"]`` equal to the tails' plain counts; the
frame counts take (2,), (3,) and (4,) sums, and give "textured" only once
a batch has added it. The ``cuda``-marked tests hold the kernel's count
to the twin's, bit for bit, on the card."""

import numpy as np
import pytest

from tests.torch_parity import cuda_device, port  # noqa: F401 (fixtures)

W, H = 96, 72
EYE = (13.566635, 4.0, 24.0)
DT = 1.0 / 60.0
LIGHTS = ((0.0, 0.0, 0.0), (1.0, 0.9, 0.8), 1.0), \
    ((-5.0, 3.0, 0.0), (0.3, 0.4, 0.5), 0.5)
MIP_FILTERS = ("trilinear", "anisotropic")


@pytest.fixture(scope="module")
def texture(port):
    from compute_renderer_torch.backends import texture

    return texture


@pytest.fixture(scope="module")
def structured(tmp_path_factory):
    """The structured scene's small build on disk (objgen's writer and
    MTL), with a 256-texel ground checker and a 32-texel marble image."""
    from compute_renderer_torch.io import objgen
    from compute_renderer_torch.io.textures import write_ppm

    d = tmp_path_factory.mktemp("structured_mip")
    path = d / "structured_mip.obj"
    objgen.write_structured_obj(path, terrain_n=120, statue_nu=80,
                                statue_nv=44, ruins=40,
                                mtl_text=objgen._STRUCTURED_MTL)
    yy, xx = np.mgrid[0:256, 0:256]
    write_ppm(d / "structured_ground.ppm", np.where(
        ((yy // 8 + xx // 8) % 2 == 0)[..., None],
        np.array([0.45, 0.55, 0.25]), np.array([0.25, 0.35, 0.15])))
    gy, gx = np.mgrid[0:32, 0:32]
    write_ppm(d / "structured_marble.ppm", np.stack(
        [0.75 + 0.2 * np.sin(gx * 0.7), 0.75 + 0.2 * np.sin(gy * 0.5),
         0.72 + 0.0 * gx], axis=-1))
    return path


def _scene(port, path, tex_filter, textures=True):
    from compute_renderer_torch.io.model import Model

    s = port.scene.Scene()
    s.add_model(Model.load(str(path), textures=textures))
    s.texture_filter = tex_filter
    for pos, color, intensity in LIGHTS:
        s.add_light(list(pos), list(color), intensity)
    s.add_camera(port.camera.Camera.first_person(list(EYE), W / H))
    s.set_active_camera(0)
    return s


def _look_around(scene, n):
    out = []
    for k in range(n):
        scene.get_active_camera().process_mouse(40.0 * (k % 3 - 1), -20.0)
        out.append(scene.update(DT))
    return out


def _mip_gbuffer(rng, h, w, levels, slots):
    """A synthetic TEXF_MIP G-buffer of two lights (tests/test_torch_mip.py's
    layout): uv, kd, slots of the table or untextured (-1), lods over the
    levels, tap axes and spreads, diff and spec; a tenth of the pixels
    uncovered (their key cleared)."""
    g = np.zeros((14, h, w), np.float32)
    g[0:2] = rng.uniform(-3.0, 3.0, (2, h, w))
    g[2:5] = rng.uniform(0.0, 1.0, (3, h, w))
    g[5] = rng.integers(-1, slots, (h, w))
    g[6] = rng.uniform(0.0, levels - 1, (h, w))
    g[7:9] = rng.uniform(-0.02, 0.02, (2, h, w))
    g[9] = rng.choice([0.0, 0.5, 0.75], (h, w))
    g[10:] = rng.uniform(0.0, 1.0, (4, h, w))
    key = rng.integers(0, 2**31, (h, w)).astype(np.uint32)
    clear = rng.random((h, w)) < 0.1
    key[clear] = 0xFFFFFFFF
    g[:, clear] = 0.0
    return g, key


def _tail_inputs(port, h=61, w=77, seed=5):
    """A G-buffer, its key, a two-slot mip pool and table, the lights."""
    from compute_renderer_torch.io.textures import trilinear_tex_arrays

    t = port.torch
    rng = np.random.default_rng(seed)
    texels = rng.uniform(0.0, 1.0, (16 * 16 + 5 * 9, 3)).astype(np.float32)
    table = np.array([[0, 16, 16], [256, 5, 9]], np.int32)
    pool, mips = trilinear_tex_arrays(texels, table)
    g, key = _mip_gbuffer(rng, h, w, mips.shape[1], 2)
    lc = t.tensor([l[1] for l in LIGHTS], dtype=t.float32)
    li = t.tensor([l[2] for l in LIGHTS], dtype=t.float32)
    return (t.from_numpy(g), t.from_numpy(key.view(np.int32)).view(t.uint32),
            t.from_numpy(pool), t.from_numpy(mips), lc, li)


def _acc(port, device="cpu"):
    return port.torch.zeros((port.binning.ACC_WORDS,),
                            dtype=port.torch.int64, device=device)


# --------------------------------------------------------------------------
# The plain count and the tail's accumulator word
# --------------------------------------------------------------------------

def test_plain_count_is_the_samplers_has(port, texture):
    g, key, pool, mips, _, _ = _tail_inputs(port)
    flag = key.view(port.torch.int32) != -1
    _, has = port.common._sample_mip_px(
        pool, mips, g[5].to(port.torch.int32), g[6], g[7], g[8], g[9], g[0],
        g[1], flag, "trilinear")
    count = texture.textured_pixels_plain(g, key)
    assert count.dtype == port.torch.int64
    assert int(count) == int(has.sum())
    covered = int(flag.sum())
    # Both kinds of covered pixel are present: textured and untextured.
    assert 0 < int(count) < covered < g.shape[1] * g.shape[2]


@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_tail_adds_its_count_to_the_sixth_word(port, texture, tex_filter):
    args = _tail_inputs(port)
    acc = _acc(port)
    acc[:5] = port.torch.tensor([7, 8, 9, 10, 11])
    plain = texture.texture_tail_mip(*args, tex_filter=tex_filter)
    for k in (1, 2):
        got = texture.texture_tail_mip(*args, tex_filter=tex_filter, acc=acc)
        assert port.torch.equal(got, plain)
        count = int(texture.textured_pixels_plain(args[0], args[1]))
        assert acc.tolist() == [7, 8, 9, 10, 11, k * count, 0, 0]


@pytest.mark.cuda
def test_tail_refuses_a_short_accumulator_on_the_card(port, texture,
                                                     cuda_device):
    args = [a.to(cuda_device) for a in _tail_inputs(port)]
    short = port.torch.zeros((5,), dtype=port.torch.int64,
                             device=cuda_device)
    with pytest.raises(ValueError):
        texture.texture_tail_mip(*args, acc=short)


# --------------------------------------------------------------------------
# The frame counts
# --------------------------------------------------------------------------

def test_add_frames_takes_two_three_or_four_words(port):
    t = port.torch
    tr = port.tracing
    tr.reset()
    tr.add_frames(t.tensor([600, 10], dtype=t.int64), 2)
    assert tr.frame_counts() == {"frames": 2, "pairs": 600, "tiles": 10}
    tr.add_frames(t.tensor([400, 20, 3000], dtype=t.int64), 2)
    assert tr.frame_counts() == {"frames": 4, "pairs": 1000, "tiles": 30,
                                 "samples": 3000}
    tr.add_frames(t.tensor([100, 5, 500, 70], dtype=t.int64), 1)
    assert tr.frame_counts() == {"frames": 5, "pairs": 1100, "tiles": 35,
                                 "samples": 3500, "textured": 70}
    # A (3,) batch after a (4,) one keeps the key.
    tr.add_frames(t.tensor([1, 1, 1], dtype=t.int64), 1)
    assert tr.frame_counts()["textured"] == 70
    tr.reset()
    assert tr.frame_counts() == {"frames": 0, "pairs": 0, "tiles": 0}


def _profile():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU])


def _record_tails(texture, monkeypatch):
    """The textured-pixel counts of every ``texture_tail_mip`` call from
    now on, by the plain count of its G-buffer and key."""
    fn, counts = texture.texture_tail_mip, []

    def recorded(gbuf, key, *args, **kwargs):
        counts.append(int(texture.textured_pixels_plain(gbuf, key)))
        return fn(gbuf, key, *args, **kwargs)

    monkeypatch.setattr(texture, "texture_tail_mip", recorded)
    return counts


def test_traced_batch_counts_textured_pixels(port, texture, structured,
                                             monkeypatch):
    # A traced trilinear batch: frame_counts() gains "textured", the sum
    # of the tails' plain counts; the frames minify (lods above 0), and
    # the terrain's pixels are textured while the statue's and the
    # ruins' are not.
    tr = port.tracing
    s = _scene(port, structured, "trilinear")
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu", path="micro",
                               **s.renderer_options())
    assert r.mode == "texf_mip"
    batch = _look_around(s, 3)
    r.render_batch_device(batch)  # the capacities settle
    counts = _record_tails(texture, monkeypatch)
    tr.reset()
    with _profile():
        r.render_batch_device(batch, check=False)
    got = tr.frame_counts()
    assert got["frames"] == 3 and len(counts) == 3
    assert got["textured"] == sum(counts)
    assert 0 < got["textured"] < 3 * W * H
    assert got["samples"] > 0 and got["pairs"] > 0
    assert not r.flush_overflow()
    rows = texture.mip_rows(r.positions, r.tri, r.ext["uvs"],
                            r.ext["face_tex"], r.ext["tex_mips"],
                            port.torch.from_numpy(np.asarray(
                                batch[0].view_proj, np.float32)),
                            port.torch.zeros(6), W, H)
    lod = rows[:, 1][r.ext["face_tex"] >= 0]
    assert float(lod.max()) > 1.0


def test_base_batch_has_no_textured_key(port, structured):
    tr = port.tracing
    s = _scene(port, structured, "trilinear", textures=False)
    r = port.renderer.Renderer(s.mesh, W, H, device="cpu", path="micro",
                               **s.renderer_options())
    assert r.mode == "base"
    batch = _look_around(s, 2)
    r.render_batch_device(batch)
    tr.reset()
    with _profile():
        r.render_batch_device(batch, check=False)
    assert set(tr.frame_counts()) == {"frames", "pairs", "tiles", "samples"}


# --------------------------------------------------------------------------
# On the card
# --------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("tex_filter", MIP_FILTERS)
def test_card_tail_count_equals_the_twins(port, texture, cuda_device,
                                          tex_filter):
    args = _tail_inputs(port, h=333, w=517)
    want = _acc(port)
    texture.texture_tail_mip(*args, tex_filter=tex_filter, acc=want)
    got = _acc(port, cuda_device)
    for _ in range(2):
        texture.texture_tail_mip(*(a.to(cuda_device) for a in args),
                                 tex_filter=tex_filter, acc=got)
    assert got.cpu().tolist() == [0] * 5 + [2 * int(want[5]), 0, 0]
    assert int(want[5]) > 0


@pytest.mark.cuda
def test_card_graph_batch_counts_textured(port, structured, cuda_device):
    # A replayed trilinear micro batch counts the twins' frame counts,
    # "textured" included.
    tr = port.tracing
    s = _scene(port, structured, "trilinear")
    batch = _look_around(s, 4)
    counts = {}
    for device in ("cpu", cuda_device):
        r = port.renderer.Renderer(s.mesh, W, H, device=device, path="micro",
                                   **s.renderer_options())
        r.render_batch_device(batch)
        tr.reset()
        with _profile():
            r.render_batch_device(batch, check=False)
        counts[str(device)] = tr.frame_counts()
        assert not r.flush_overflow()
        r.close()
    assert counts["cpu"] == counts[str(cuda_device)]
    assert counts["cpu"]["textured"] > 0


# --------------------------------------------------------------------------
# The G-buffer's contract: planes defined where the key is set
# --------------------------------------------------------------------------

# Words written over a G-buffer's key-clear pixels: a quiet NaN and
# 0xDEADBEEF.
POISONS = {"nan": 0x7FC00001, "deadbeef": -0x21524111}
# (mode, tex_filter, pool) of each fused tail the engine's frames reach.
TAIL_CASES = [("texf", "nearest", "f32"), ("texf", "bilinear", "f32"),
              ("texf", "nearest", "packed"), ("texf", "bilinear", "packed"),
              ("texf_mip", "trilinear", "f32"),
              ("texf_mip", "anisotropic", "f32")]


@pytest.fixture(scope="module")
def engine_gbuffers():
    """The G-buffers ``_engine_gbuffer`` recorded, by device, path and
    filter."""
    return {}


def _engine_gbuffer(port, texture, structured, cache, device, path,
                    tex_filter):
    """(gbuf, key, args) that the engine's raster hands its fused tail on
    ``device`` in one eager frame of the structured scene on ``path``:
    the kernels' G-buffer on the card, the twins' on the CPU. ``args``
    are the tail's after the key (texels, [mip table,] light colours and
    intensities)."""
    k = (str(device), path, tex_filter)
    if k not in cache:
        calls = []
        with pytest.MonkeyPatch.context() as mp:
            for name in ("texture_tail", "texture_tail_mip"):
                def recorded(gbuf, key, *args, _fn=getattr(texture, name),
                             **kwargs):
                    calls.append((gbuf.clone(), key.clone(), args))
                    return _fn(gbuf, key, *args, **kwargs)
                mp.setattr(texture, name, recorded)
            s = _scene(port, structured, tex_filter)
            # Small tiles: the distant terrain crowds the tile lists.
            r = port.renderer.Renderer(s.mesh, W, H, device=device,
                                       path=path, tile_h=8, tile_w=16,
                                       **s.renderer_options())
            r.render_batch_device([s.update(DT)], eager=True)
            r.close()
        cache[k] = calls[-1]  # a retried frame's last
    return cache[k]


@pytest.mark.parametrize("poison", list(POISONS))
@pytest.mark.parametrize("mode,tex_filter,pool", TAIL_CASES)
@pytest.mark.parametrize("path", ["tile", "micro"])
@pytest.mark.parametrize("device",
                         ["cpu", pytest.param("cuda", marks=pytest.mark.cuda)])
def test_poisoned_gbuffer_renders_the_same_image(
        port, texture, structured, engine_gbuffers, request, device, path,
        mode, tex_filter, pool, poison):
    # The engine's own G-buffer with its key-clear pixels poisoned: the
    # tail (the kernel on the card) gives the RGBA and, under texf_mip,
    # the textured count of the same G-buffer zeroed there, bit for bit,
    # and so does the tail's plain version.
    from compute_renderer_torch.io.textures import pack_pool_u8

    t = port.torch
    if device == "cuda":
        device = request.getfixturevalue("cuda_device")
    gbuf, key, args = _engine_gbuffer(
        port, texture, structured, engine_gbuffers, device, path,
        "nearest" if mode == "texf" else tex_filter)
    assert gbuf.shape[0] == (14 if mode == "texf_mip" else 12)
    clear = key.view(t.int32) == -1
    assert 1000 < int((~clear).sum()) < clear.numel()  # sky above
    zeroed = port.raster.defined_planes(gbuf, key)
    poisoned = zeroed.clone()
    poisoned.view(t.int32)[:, clear] = POISONS[poison]
    assert int((poisoned.view(t.int32) != zeroed.view(t.int32)).sum()) == \
        gbuf.shape[0] * int(clear.sum())

    if mode == "texf":
        packed = None
        if pool == "packed":
            packed = pack_pool_u8(args[0].cpu().numpy())
            assert packed is not None
            packed = t.from_numpy(packed).to(device)
        kw = dict(tex_filter=tex_filter, texels_packed=packed)
        tails = (texture.texture_tail, texture.texture_tail_plain)
    else:
        kw = dict(tex_filter=tex_filter)
        tails = (texture.texture_tail_mip, texture.texture_tail_mip_plain)
    background = t.tensor([0, 0, 255, 255], dtype=t.uint8, device=device)
    for tail in tails:
        counted = tail is texture.texture_tail_mip
        accs = [_acc(port, device) for _ in range(2)]
        images = [tail(g, key, *args, **kw, **({"acc": a} if counted else {}))
                  for g, a in zip((zeroed, poisoned), accs)]
        assert t.equal(images[0], images[1]), tail.__name__
        assert bool((images[1][clear] == background).all())
        assert t.equal(accs[0], accs[1])
        if counted:
            plain = [int(texture.textured_pixels_plain(g, key))
                     for g in (zeroed, poisoned)]
            assert int(accs[0][5]) == plain[0] == plain[1] > 0
