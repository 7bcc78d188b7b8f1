"""Tile binning (backends/binning.py) against the JAX package, bitwise.

The same numpy setup dict goes into the JAX package's
``bin_triangles_dense`` / ``bin_triangles_sort`` and into the port's; every
integer output the raster reads or the retry logic uses must agree bit for
bit: the bin rows, segments, the sorted pair list up to the true total,
and the needed capacities, overflow included."""

import numpy as np
import pytest

from tests.torch_parity import cuda_device, port, tpu  # noqa: F401 (fixtures)

NTX, NTY = 4, 12  # 1024x192 at 16x256 tiles, or 256x192 at 8x64-ish


def _random_setup(seed, T=600, ntx=NTX, nty=NTY, span=3):
    rng = np.random.default_rng(seed)
    x0 = rng.integers(0, ntx, T).astype(np.int32)
    y0 = rng.integers(0, nty, T).astype(np.int32)
    x1 = np.minimum(x0 + rng.integers(1, span + 1, T), ntx).astype(np.int32)
    y1 = np.minimum(y0 + rng.integers(1, span + 1, T), nty).astype(np.int32)
    alive = rng.random(T) < 0.8
    x1 = np.where(alive, x1, x0)
    y1 = np.where(alive, y1, y0)
    return {"alive": alive, "tile_x0": x0, "tile_y0": y0, "tile_x1": x1,
            "tile_y1": y1}


def _scene_setup(tpu, name="suzanne.obj", W=1024, H=192):
    mesh = tpu.procedural.make_model(name)
    cam = tpu.camera.Camera.first_person([0.0, 0.0, 3.0], aspect=W / H)
    u = cam.uniform()
    jnp = tpu.jnp
    world, screen = tpu.common.vertex_stage(
        jnp.asarray(mesh.positions), jnp.asarray(u.view_proj),
        jnp.zeros(6, jnp.float32), W, H)
    tri = jnp.asarray(mesh.indices.astype(np.int32)).reshape(-1, 3)
    s = tpu.common.triangle_setup(screen, tri, jnp.zeros(6, jnp.float32),
                                  W, H, 16, 256)
    return {k: np.array(s[k]) for k in ("alive", "tile_x0", "tile_y0",
                                        "tile_x1", "tile_y1")}


def _both(port, tpu, fn_name, setup, ntx, nty, pair_cap, tile_cap):
    a = getattr(tpu.binning, fn_name)(
        {k: tpu.jnp.asarray(v) for k, v in setup.items()}, ntx, nty,
        pair_cap, tile_cap)
    b = getattr(port.binning, fn_name)(
        {k: port.torch.from_numpy(v) for k, v in setup.items()}, ntx, nty, pair_cap, tile_cap)
    return a, b


def _check(a, b, num_tiles):
    assert a["layout"] == b["layout"]
    for k in ("seg_start", "seg_count", "total_pairs", "pair_needed",
              "tile_needed"):
        np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy(),
                                      err_msg=k)
    if a["layout"] == "dense":
        np.testing.assert_array_equal(
            np.asarray(a["bin_rows"])[:num_tiles], b["bin_rows"].numpy())
    else:
        total = min(int(a["total_pairs"]), b["pair_tri"].shape[0])
        np.testing.assert_array_equal(np.asarray(a["pair_tri"])[:total],
                                      b["pair_tri"].numpy()[:total])


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("fn", ["bin_triangles_dense", "bin_triangles_sort"])
def test_random_rects(port, tpu, fn, seed):
    setup = _random_setup(seed)
    a, b = _both(port, tpu, fn, setup, NTX, NTY, 4096, 256)
    _check(a, b, NTX * NTY)
    assert int(b["tile_needed"]) == 0 and int(b["pair_needed"]) == 0


@pytest.mark.parametrize("fn", ["bin_triangles_dense", "bin_triangles_sort"])
def test_tile_overflow_reports_need(port, tpu, fn):
    # tile_cap 96 (128 after the dense path's rounding) against ~190
    # triangles per tile: the report must carry the exact max count.
    setup = _random_setup(5, T=5000, span=2)
    a, b = _both(port, tpu, fn, setup, NTX, NTY, 16384, 96)
    _check(a, b, NTX * NTY)
    assert int(b["tile_needed"]) > 96


def test_pair_overflow_reports_exact_need(port, tpu):
    # pair_cap far below the true total: the sort path's per-tile counts
    # come from the bounded list, so the exact corner-scatter count decides
    # tile_needed; both needs must match the JAX package's.
    setup = _random_setup(6, T=3000, span=4)
    a, b = _both(port, tpu, "bin_triangles_sort", setup, NTX, NTY, 2048, 64)
    _check(a, b, NTX * NTY)
    assert int(b["pair_needed"]) > 2048
    assert int(b["tile_needed"]) > 64


@pytest.mark.parametrize("fn", ["bin_triangles_dense", "bin_triangles_sort"])
def test_suzanne_setup(port, tpu, fn):
    setup = _scene_setup(tpu)
    a, b = _both(port, tpu, fn, setup, 4, 12, 2560, 128)
    _check(a, b, 48)
    assert int(b["total_pairs"]) > 0


def test_dispatch_picks_same_layout(port, tpu):
    setup = _scene_setup(tpu)
    for tile_cap in (128, 8192):
        a, b = _both(port, tpu, "bin_triangles", setup, 4, 12, 4096,
                     tile_cap)
        assert a["layout"] == b["layout"]
        _check(a, b, 48)


def test_cover_counts_exact_tile_counts_setup_from_meta(port, tpu):
    setup = _random_setup(7, T=800)
    js = {k: tpu.jnp.asarray(v) for k, v in setup.items()}
    ts = {k: port.torch.from_numpy(v) for k, v in setup.items()}
    for x, y in zip(tpu.binning.cover_counts(js),
                    port.binning.cover_counts(ts)):
        np.testing.assert_array_equal(np.asarray(x), y.numpy())
    np.testing.assert_array_equal(
        np.asarray(tpu.binning.exact_tile_counts(js, NTX, NTY)),
        port.binning.exact_tile_counts(ts, NTX, NTY).numpy())
    rx, _, c = port.binning.cover_counts(ts)
    meta = port.torch.stack([ts["tile_x0"], ts["tile_y0"], rx, c])
    a = tpu.binning.setup_from_meta(tpu.jnp.asarray(meta.numpy()))
    b = port.binning.setup_from_meta(meta)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), b[k].numpy(),
                                      err_msg=k)


def test_expand_pair_owners(port, tpu):
    rng = np.random.default_rng(8)
    c = rng.integers(0, 4, 300).astype(np.int32)
    c[::7] = 0
    starts = (np.cumsum(c) - c).astype(np.int32)
    for cap in (int(c.sum()) + 50, int(c.sum()) // 2):
        a = tpu.binning.expand_pair_owners(tpu.jnp.asarray(starts),
                                           tpu.jnp.asarray(c), cap)
        b = port.binning.expand_pair_owners(port.torch.from_numpy(starts),
                                            port.torch.from_numpy(c), cap)
        np.testing.assert_array_equal(np.asarray(a), b.numpy())


@pytest.mark.parametrize("T,W,H", [(1280, 1024, 768), (41984, 256, 192),
                                   (16384, 1024, 768), (3, 64, 64)])
def test_default_caps(port, tpu, T, W, H):
    assert port.binning.default_pair_cap(T, 192) == \
        tpu.binning.default_pair_cap(T, 192)
    assert port.binning.default_tile_cap(T, W, H, 16, 256) == \
        tpu.binning.default_tile_cap(T, W, H, 16, 256)
    assert port.cuda.default_caps("tile", T, W, H) == \
        tpu.backend.default_caps("tile", T, W, H)
    for need in (100, 1000, 5000):
        assert port.cuda.grow_pair_cap(2048, need) == \
            tpu.backend.grow_pair_cap(2048, need)
        assert port.cuda.grow_tile_cap(128, need, 16, 256) == \
            tpu.backend.grow_tile_cap(128, need, 16, 256)


@pytest.mark.cuda
@pytest.mark.parametrize("fn", ["bin_triangles_dense", "bin_triangles_sort"])
@pytest.mark.parametrize("pair_cap,tile_cap", [(16384, 512), (2048, 64)])
def test_card_binning_matches_cpu(port, cuda_device, fn, pair_cap, tile_cap):
    # The same torch ops on the card (sort, searchsorted, cummax, scatter)
    # give the CPU's integers, overflow reports included.
    setup = _random_setup(9, T=3000, span=3)
    f = getattr(port.binning, fn)
    cpu = f({k: port.torch.from_numpy(v) for k, v in setup.items()}, NTX,
            NTY, pair_cap, tile_cap)
    gpu = f({k: port.torch.from_numpy(v).to(cuda_device)
             for k, v in setup.items()}, NTX, NTY, pair_cap, tile_cap)
    for k in ("seg_start", "seg_count", "total_pairs", "pair_needed",
              "tile_needed", "bin_rows" if fn.endswith("dense")
              else "pair_tri"):
        a, b = cpu[k], gpu[k].cpu()
        if k == "pair_tri":  # only [0, total) is defined
            n = min(int(cpu["total_pairs"]), a.shape[0])
            a, b = a[:n], b[:n]
        assert port.torch.equal(a, b), k
