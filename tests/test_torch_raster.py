"""Raster + shade (backends/raster.py) against the JAX package's
``pallas_raster.raster_shade_tiles`` in interpret mode, work-list grid.

Both packages get the same numpy coefficient table and bins (built by the
JAX package's own chain), so only the raster itself differs. XLA:CPU
contracts mul+add into FMA in the interpret-mode kernel, which flips
samples that sit exactly on an edge; so at most max(2, H*W/500) pixels
may differ (tests/test_front_kernel.py:336-340), in colour by more than
1 LSB or in depth key. The CUDA kernel is held against the twin (keys
bitwise, RGBA within 1 LSB) only where a card exists."""

import numpy as np
import pytest

from tests.torch_parity import (  # noqa: F401 (fixtures)
    W, H, assert_frames_match, cuda_device, pixel_budget, port, tpu,
)

TILE = (16, 256)
LIGHTS = (np.array([[0.0, 0.0, 5.0], [-5.0, 3.0, 0.0], [2.0, -1.0, 4.0]],
                   np.float32),
          np.array([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5], [0.2, 0.9, 0.3]],
                   np.float32),
          np.array([1.0, 0.5, 0.7], np.float32))
EFFECTS = {
    "none": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "edge_melt": [2.0, 0.25, 0.8, 0.0, 0.0, 2.1],
    "voxelize": [3.0, 0.3, 0.0, 0.0, 0.0, 0.4],
    "mirage": [4.0, 0.6, 0.05, 0.3, 1.0, 1.7],
}


def _mesh(pkg, name):
    """(mesh, (T, 3) int32 indices) from either package's procedural module.
    "icosphere+degenerate" appends 100 zero-area triangles over the
    sphere's vertices: under voxelize (no backface cull) they stay alive
    with NaN coefficients, and must cover nothing."""
    if name.startswith("icosphere"):
        mesh = pkg.procedural.icosphere(3)
    else:
        mesh = pkg.procedural.make_model(name)
    tri = mesh.indices.astype(np.int32).reshape(-1, 3)
    if name.endswith("+degenerate"):
        a = np.arange(0, 300, 3, dtype=np.int32)
        tri = np.concatenate([np.stack([a, a, a + 1], axis=1), tri])
    return mesh, tri


def _scene(tpu, name, effect, layout, tile=TILE):
    """Table, bins and shading inputs from the JAX package's chain."""
    jnp = tpu.jnp
    mesh, tri = _mesh(tpu, name)
    cam = tpu.camera.Camera.first_person([0.1, 0.05, 3.0], aspect=W / H)
    u = cam.uniform()
    eff = jnp.asarray(np.asarray(EFFECTS[effect], np.float32))
    tri = jnp.asarray(tri)
    world, screen = tpu.common.vertex_stage(jnp.asarray(mesh.positions),
                                            jnp.asarray(u.view_proj), eff,
                                            W, H)
    setup = tpu.common.triangle_setup(screen, tri, eff, W, H, *tile)
    table = tpu.pallas_raster.build_tri_table(
        screen, tri, jnp.asarray(mesh.uvs), jnp.asarray(mesh.normals), world)
    ntx, nty = (W + tile[1] - 1) // tile[1], (H + tile[0] - 1) // tile[0]
    T = tri.shape[0]
    tile_cap = min(tpu.binning.default_tile_cap(T, W, H, *tile), 8192)
    exact = int(np.asarray(tpu.binning.exact_tile_counts(setup, ntx,
                                                         nty)).max())
    tile_cap = max(tile_cap, exact)
    pair_cap = max(tpu.binning.default_pair_cap(T, ntx * nty),
                   int(np.asarray(tpu.binning.cover_counts(setup)[2]).sum()))
    binner = (tpu.binning.bin_triangles_dense if layout == "dense"
              else tpu.binning.bin_triangles_sort)
    bins = binner(setup, ntx, nty, pair_cap, tile_cap)
    assert not int(bins["tile_needed"]) and not int(bins["pair_needed"])
    return {
        "table": np.array(table), "layout": layout,
        "pair_data": np.array(bins["bin_rows" if layout == "dense"
                                   else "pair_tri"]),
        "seg_start": np.array(bins["seg_start"]),
        "seg_count": np.array(bins["seg_count"]),
        "effect": np.asarray(EFFECTS[effect], np.float32),
        "view_position": np.asarray(u.view_position, np.float32),
        "lights": LIGHTS, "tile_cap": tile_cap, "tile": tile,
        "padded": (nty * tile[0], ntx * tile[1]),
    }


def _jax_raster(tpu, s):
    jnp = tpu.jnp
    rgba, key = tpu.pallas_raster.raster_shade_tiles(
        jnp.asarray(s["table"]), jnp.asarray(s["pair_data"]),
        jnp.asarray(s["seg_start"]), jnp.asarray(s["seg_count"]),
        jnp.asarray(s["effect"]), jnp.asarray(s["view_position"]),
        *[jnp.asarray(a) for a in s["lights"]],
        height_padded=s["padded"][0], width_padded=s["padded"][1],
        tile_h=s["tile"][0], tile_w=s["tile"][1], tile_cap=s["tile_cap"],
        layout=s["layout"], interpret=True, worklist=True)
    return np.asarray(rgba), np.asarray(key)


def _port_raster(port, s, device="cpu"):
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a)).to(device)
    rows = s["pair_data"]
    if s["layout"] == "dense":
        rows = rows[:s["seg_count"].shape[0]]  # the port keeps no pad rows
    rgba, key = port.raster.raster_shade_tiles(
        dev(s["table"]), dev(rows), dev(s["seg_start"]), dev(s["seg_count"]),
        dev(s["effect"]), dev(s["view_position"]),
        *[dev(a) for a in s["lights"]],
        height_padded=s["padded"][0], width_padded=s["padded"][1],
        tile_h=s["tile"][0], tile_w=s["tile"][1], layout=s["layout"])
    return rgba, key


def _unpack(packed):
    return np.asarray(packed).view(np.uint8).reshape(*packed.shape, 4)


@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("name,effect", [
    ("icosphere", "none"), ("icosphere", "edge_melt"),
    ("icosphere+degenerate", "voxelize"), ("icosphere", "mirage"),
    ("san_miguel_small.obj", "none"),
])
def test_twin_vs_pallas_raster(port, tpu, name, effect, layout):
    s = _scene(tpu, name, effect, layout)
    ra, ka = _jax_raster(tpu, s)
    rb, kb = _port_raster(port, s)
    assert rb.dtype == port.torch.uint32 and kb.dtype == port.torch.uint32
    rb, kb = rb.numpy(), kb.numpy()
    assert rb.shape == ra.shape and kb.shape == ka.shape
    assert_frames_match(_unpack(ra), _unpack(rb), lsb=1)
    budget = pixel_budget(*ka.shape)
    assert int((ka != kb).sum()) <= budget
    covered = kb != 0xFFFFFFFF
    assert covered.any()
    # Uncovered pixels are the blue background.
    assert (rb[~covered] == 0xFFFF0000).all()


@pytest.mark.parametrize("occupied", [0.0, 0.3, 1.0])
def test_occupied_worklist_bitwise(port, tpu, occupied):
    # No tile, some tiles and every tile occupied.
    rng = np.random.default_rng(11)
    counts = np.where(rng.random(300) < occupied, rng.integers(1, 9, 300),
                      0).astype(np.int32)
    wa, ka = tpu.pallas_raster.occupied_worklist(tpu.jnp.asarray(counts))
    wb, kb = port.raster.occupied_worklist(port.torch.from_numpy(counts))
    np.testing.assert_array_equal(np.asarray(wa), wb.numpy())
    assert int(ka) == int(kb)


def test_build_tri_table_vs_jax(port, tpu):
    mesh = tpu.procedural.icosphere(2)
    rng = np.random.default_rng(12)
    n = mesh.num_vertices
    screen = np.concatenate([rng.uniform(0, 256, (n, 2)),
                             rng.uniform(0.1, 1, (n, 1)),
                             rng.uniform(0.5, 4, (n, 1))], 1).astype(
        np.float32)
    world = rng.standard_normal((n, 3)).astype(np.float32)
    tri = mesh.indices.astype(np.int32).reshape(-1, 3)
    jnp = tpu.jnp
    with tpu.jax.disable_jit():  # op by op: no FMA contraction
        a = tpu.pallas_raster.build_tri_table(
            jnp.asarray(screen), jnp.asarray(tri), jnp.asarray(mesh.uvs),
            jnp.asarray(mesh.normals), jnp.asarray(world))
    t = port.torch
    b = port.raster.build_tri_table(t.from_numpy(screen), t.from_numpy(tri),
                                    t.from_numpy(mesh.normals),
                                    t.from_numpy(world))
    assert b.shape == (tri.shape[0], port.raster.TRI_TABLE_WIDTH)
    np.testing.assert_array_equal(np.asarray(a).view(np.int32),
                                  b.numpy().view(np.int32))


def test_unpack_rgba_bitwise(port, tpu):
    rng = np.random.default_rng(13)
    packed = rng.integers(0, 2**32, (7, 9), dtype=np.uint64).astype(
        np.uint32)
    a = np.asarray(tpu.pallas_raster.unpack_rgba(tpu.jnp.asarray(packed)))
    b = port.raster.unpack_rgba(
        port.torch.from_numpy(packed.view(np.int32)).view(port.torch.uint32))
    np.testing.assert_array_equal(a, b.numpy())


def test_degenerate_triangles_cover_nothing(port):
    # The 100 zero-area triangles of "icosphere+degenerate" are binned
    # (alive under voxelize) but their NaN coefficients cover no pixel:
    # the frame equals the plain icosphere's.
    a = _port_scene(port, "icosphere+degenerate", "voxelize", "dense")
    b = _port_scene(port, "icosphere", "voxelize", "dense")
    assert np.isnan(a["table"][:100, 0]).all()
    assert a["seg_count"].sum() > b["seg_count"].sum()  # they are binned
    ra, ka = _port_raster(port, a)
    rb, kb = _port_raster(port, b)
    np.testing.assert_array_equal(ka.numpy(), kb.numpy())
    np.testing.assert_array_equal(ra.numpy(), rb.numpy())


def test_unported_modes_raise(port, tpu):
    # The mode is an argument, and the table must have its width: a mode
    # that names no kernel mode, or a width that is not the mode's, is
    # refused. Every mode of the TPU kernel is ported.
    s = _scene(tpu, "icosphere", "none", "dense")
    t = port.torch
    args = [t.from_numpy(np.ascontiguousarray(a)) for a in (
        s["table"], s["pair_data"][:48], s["seg_start"], s["seg_count"],
        s["effect"], s["view_position"], *s["lights"])]
    kw = dict(height_padded=s["padded"][0], width_padded=s["padded"][1],
              tile_h=16, tile_w=256, layout="dense")
    T = s["table"].shape[0]
    with pytest.raises(ValueError, match="46"):
        port.raster.raster_shade_tiles(t.zeros((T, 46)), *args[1:], **kw)
    with pytest.raises(ValueError, match="44"):
        port.raster.raster_shade_tiles(t.zeros((T, 33)), *args[1:], **kw)
    with pytest.raises(ValueError, match="modes"):
        port.raster.raster_shade_tiles(*args, mode="lit", **kw)
    assert set(port.raster.MODES) == {"base", "mat", "texf", "vis",
                                      "texf_mip"}
    mat = t.cat([args[0], t.ones((T, 3))], dim=1)
    rgba, key = port.raster.raster_shade_tiles(mat, *args[1:], mode="mat",
                                               **kw)
    base_rgba, base_key = port.raster.raster_shade_tiles(*args, **kw)
    assert t.equal(key, base_key) and t.equal(rgba, base_rgba)  # kd = 1
    cols = port.raster.tri_table_columns(
        *[tuple(tuple(t.ones(4) for _ in range(4)) for _ in range(3))] * 3,
        face_kd=t.ones((4, 3)))
    assert len(cols) == port.raster.MAT_TRI_TABLE_WIDTH


def _port_scene(port, name, effect, layout, tile=TILE, num_lights=2):
    """The inputs of ``_scene`` built by the port's own chain (the card's
    machine has no JAX)."""
    t = port.torch
    mesh, tri = _mesh(port, name)
    cam = port.camera.Camera.first_person([0.1, 0.05, 3.0], aspect=W / H)
    u = cam.uniform()
    eff = t.tensor(EFFECTS[effect], dtype=t.float32)
    tri = t.from_numpy(tri)
    world, screen = port.common.vertex_stage(
        t.from_numpy(mesh.positions), t.from_numpy(u.view_proj), eff, W, H)
    setup = port.common.triangle_setup(screen, tri, eff, W, H, *tile)
    table = port.raster.build_tri_table(screen, tri,
                                        t.from_numpy(mesh.normals), world)
    ntx, nty = (W + tile[1] - 1) // tile[1], (H + tile[0] - 1) // tile[0]
    tile_cap = int(port.binning.exact_tile_counts(setup, ntx, nty).max())
    pair_cap = int(port.binning.cover_counts(setup)[2].sum())
    binner = (port.binning.bin_triangles_dense if layout == "dense"
              else port.binning.bin_triangles_sort)
    bins = binner(setup, ntx, nty, max(pair_cap, 1), max(tile_cap, 1))
    lights = tuple(a[:num_lights] for a in LIGHTS)
    return {
        "table": table.numpy(), "layout": layout,
        "pair_data": bins["bin_rows" if layout == "dense"
                          else "pair_tri"].numpy(),
        "seg_start": bins["seg_start"].numpy(),
        "seg_count": bins["seg_count"].numpy(),
        "effect": np.asarray(EFFECTS[effect], np.float32),
        "view_position": np.asarray(u.view_position, np.float32),
        "lights": lights, "tile": tile,
        "padded": (nty * tile[0], ntx * tile[1]),
    }


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["dense", "flat"])
@pytest.mark.parametrize("name,effect", [
    ("icosphere", "none"), ("icosphere", "mirage"),
    ("icosphere", "edge_melt"), ("icosphere+degenerate", "voxelize"),
    ("san_miguel_small.obj", "none"),
])
def test_kernel_vs_twin_on_card(port, cuda_device, name, effect, layout):
    s = _port_scene(port, name, effect, layout)
    _check_kernel_vs_twin(port, cuda_device, s)


@pytest.mark.cuda
@pytest.mark.parametrize("tile,num_lights", [((8, 128), 1), ((16, 256), 3),
                                             ((32, 128), 2)])
def test_kernel_vs_twin_on_card_shapes(port, cuda_device, tile, num_lights):
    # Other tile shapes (up to the kernel's 4,096 pixels) and light counts.
    s = _port_scene(port, "icosphere", "none", "flat", tile=tile,
                    num_lights=num_lights)
    _check_kernel_vs_twin(port, cuda_device, s)


def _check_kernel_vs_twin(port, cuda_device, s):
    before = port.tracing.count("launches.raster_shade_tiles")
    rk, kk = _port_raster(port, s, device=cuda_device)
    assert port.tracing.count("launches.raster_shade_tiles") == before + 1
    rp, kp = _port_raster(port, s, device="cpu")
    assert (kk.cpu().view(port.torch.int32) == kp.view(port.torch.int32)).all()
    gap = np.abs(_unpack(rk.cpu().numpy()).astype(int)
                 - _unpack(rp.numpy()).astype(int))
    assert gap.max() <= 1
