"""The fused front end (backends/front.py) against the JAX package, at the
tile path's 16x256 granularity.

Two references:

- the JAX package's plain XLA chain (``vertex_stage_soa`` ->
  ``triangle_setup_soa`` -> ``tri_table_columns``) run op by op under
  ``jax.disable_jit()``: contraction-free IEEE float32 in the same op order
  (the arithmetic the TPU runs), so ``coeff`` and ``meta`` must match
  BITWISE. With the wave effect, XLA's ``sin`` and torch's differ in the
  last bit, so there ``coeff`` is held within rtol=2e-6, atol=1e-6 (the
  tests/test_front_kernel.py:63 contract) and ``meta`` bitwise;
- ``pallas_front.front_end`` in interpret mode, as the JAX package's own
  tests run it: ``meta`` rects bitwise for alive triangles
  (tests/test_front_kernel.py:343-366) and, on those, NaNs in the same
  places (a contracted cross product can turn a dead sliver's zero area
  nonzero). Its
  coefficients are not compared element-wise: XLA:CPU contracts mul+add
  into FMA inside the compiled kernel, and the cancellations in the cross
  product and the edge differences amplify that rounding — 2.5% of the
  icosphere's coefficients differ by more than rtol=2e-6, up to 2e-4
  relative. The rendered frames, which those coefficients feed, are held
  to the pixel contract in test_torch_raster.py and test_torch_slice.py.

The port's front returns the rasters' (T, R) table, the JAX package's the
(R, T) rows, so the port's table is held against the transposed rows. The
table's layout is the one ``raster.kernel_table`` passes on without a copy
(checked in every mode at both granularities). The CUDA kernel is held
against the twin only where a card exists."""

import numpy as np
import pytest

from tests.torch_parity import (  # noqa: F401 (fixtures)
    W, H, assert_close_nan, cuda_device, port, tpu,
)


def _soup(seed=7, n=3000, bad=False):
    """A random triangle soup (off-screen and behind-camera corners
    included); ``bad`` adds zero-area triangles and NaN / inf corners."""
    rng = np.random.default_rng(seed)
    pos = (rng.standard_normal((3 * n, 3)) * 1.7).astype(np.float32)
    nrm = rng.standard_normal((3 * n, 3)).astype(np.float32)
    if bad:
        pos[1:600:6] = pos[0:600:6]  # corners 0 and 1 coincide
        pos[3001:3300:9, 0] = np.nan
        pos[4002:4300:9, 1] = np.inf
    return pos, nrm, np.arange(3 * n, dtype=np.int32).reshape(-1, 3)


def _mesh(pkg, name):
    """Geometry from either package's (numpy, identical) procedural
    module: the card's tests pass the port, which needs no JAX."""
    if name.startswith("soup"):
        return _soup(bad=name == "soup+bad")
    m = {"icosphere": lambda: pkg.procedural.icosphere(3),
         "torus": lambda: pkg.procedural.torus(32, 16),
         "san_miguel_small": lambda: pkg.procedural.make_model(
             "san_miguel_small.obj")}[name]()
    return m.positions, m.normals, m.indices.astype(np.int32).reshape(-1, 3)


EFFECTS = {
    "none": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "wave": [1.0, 0.4, 3.0, 0.7, 0.0, 1.3],
    "wave_radial": [1.0, 0.5, 4.0, 1.1, 2.0, 0.9],
    "voxelize": [3.0, 0.35, 0.0, 0.0, 0.0, 0.4],
}


def _inputs(pkg, name, effect, position=(0.0, 0.0, 3.0)):
    pos, nrm, tri = _mesh(pkg, name)
    cam = pkg.camera.Camera.first_person(list(position), aspect=W / H)
    vp = cam.uniform().view_proj
    pos_soa = np.ascontiguousarray(pos[tri].transpose(1, 2, 0))
    nrm_soa = np.ascontiguousarray(nrm[tri].transpose(1, 2, 0))
    return pos_soa, nrm_soa, vp, np.asarray(EFFECTS[effect], np.float32)


def _port_front(port, inputs, tile=(16, 256), fn=None):
    t = port.torch
    fn = fn or port.front.front_end
    table, meta = fn(*[t.from_numpy(a) for a in inputs], width=W, height=H,
                     tile_h=tile[0], tile_w=tile[1])
    return table.numpy(), meta.numpy()


CASES = [
    ("icosphere", "none"), ("torus", "none"), ("soup", "none"),
    ("icosphere", "wave"), ("torus", "wave_radial"), ("soup", "voxelize"),
    ("soup+bad", "voxelize"), ("san_miguel_small", "none"),
]


def _xla_chain(tpu, inputs, tile=(16, 256)):
    """The JAX package's plain front chain, op by op (no contraction):
    coeff (32, T) and meta (4, T) as numpy."""
    jnp = tpu.jnp
    pos_soa, nrm_soa, vp, eff = (jnp.asarray(a) for a in inputs)
    with tpu.jax.disable_jit():
        world, screen = tpu.common.vertex_stage_soa(pos_soa, vp, eff, W, H)
        setup = tpu.common.triangle_setup_soa(screen, eff, W, H, *tile)
        nrm = tuple(tuple(nrm_soa[k, c] for c in range(3)) for k in range(3))
        cols = tpu.pallas_raster.tri_table_columns(screen, nrm, world)
        rx, _, c = tpu.binning.cover_counts(setup)
        meta = np.stack([np.asarray(setup["tile_x0"]),
                         np.asarray(setup["tile_y0"]), np.asarray(rx),
                         np.asarray(c)]).astype(np.int32)
    return np.stack([np.asarray(r) for r in cols]), meta


@pytest.mark.parametrize("name,effect", CASES)
def test_twin_vs_xla_chain(port, tpu, name, effect):
    inputs = _inputs(tpu, name, effect)
    ca, ma = _xla_chain(tpu, inputs)
    cb, mb = _port_front(port, inputs)
    assert cb.dtype == np.float32 and mb.dtype == np.int32
    ca = ca.T  # the (T, 32) table
    assert cb.shape == ca.shape
    if effect.startswith("wave"):
        assert_close_nan(ca, cb)
    else:  # bitwise, except NaN sign / payload bits
        nan = np.isnan(ca)
        np.testing.assert_array_equal(nan, np.isnan(cb))
        np.testing.assert_array_equal(ca.view(np.int32)[~nan],
                                      cb.view(np.int32)[~nan])
    alive = ma[3] > 0
    np.testing.assert_array_equal(ma[:, alive], mb[:, alive])
    np.testing.assert_array_equal(alive, mb[3] > 0)
    assert alive.any()


@pytest.mark.parametrize("name,effect", [
    ("icosphere", "none"), ("soup+bad", "voxelize"),
    ("san_miguel_small", "none"),
])
def test_twin_vs_xla_chain_at_cells(port, tpu, name, effect):
    # The micro path runs the front end at 8x8-cell granularity: meta and
    # coefficients bitwise there too.
    inputs = _inputs(tpu, name, effect)
    ca, ma = _xla_chain(tpu, inputs, tile=(8, 8))
    cb, mb = _port_front(port, inputs, tile=(8, 8))
    ca = ca.T
    assert cb.shape == ca.shape
    nan = np.isnan(ca)
    np.testing.assert_array_equal(nan, np.isnan(cb))
    np.testing.assert_array_equal(ca.view(np.int32)[~nan],
                                  cb.view(np.int32)[~nan])
    alive = ma[3] > 0
    np.testing.assert_array_equal(alive, mb[3] > 0)
    np.testing.assert_array_equal(ma[:, alive], mb[:, alive])
    assert alive.any()


# "soup+bad" is left out here: under voxelize its zero-area triangles are
# alive, and a contracted cross product gives them a tiny nonzero area —
# finite coefficients where the contraction-free arithmetic has NaN.
@pytest.mark.parametrize("name,effect",
                         [c for c in CASES if c[0] != "soup+bad"])
def test_twin_vs_pallas_front(port, tpu, name, effect):
    inputs = _inputs(tpu, name, effect)
    jnp = tpu.jnp
    ca, ma = tpu.pallas_front.front_end(
        *[jnp.asarray(a) for a in inputs], width=W, height=H, tile_h=16,
        tile_w=256, interpret=True)
    cb, mb = _port_front(port, inputs)
    ca, ma = np.asarray(ca).T, np.asarray(ma)
    assert cb.shape == ca.shape and mb.shape == ma.shape
    alive_a, alive_b = ma[3] > 0, mb[3] > 0
    np.testing.assert_array_equal(alive_a, alive_b)
    np.testing.assert_array_equal(ma[:, alive_a], mb[:, alive_b])
    np.testing.assert_array_equal(np.isnan(ca[alive_a]),
                                  np.isnan(cb[alive_b]))
    assert alive_b.any()


@pytest.mark.parametrize("tile", [(16, 256), (8, 128)])
def test_twin_meta_feeds_setup_from_meta(port, tpu, tile):
    # The binning's setup reconstructed from the twin's meta equals the
    # JAX package's per-vertex common.triangle_setup rects for alive
    # triangles.
    inputs = _inputs(tpu, "icosphere", "none")
    _, meta = _port_front(port, inputs, tile)
    rec = port.binning.setup_from_meta(port.torch.from_numpy(meta))
    pos, _, tri = _mesh(tpu, "icosphere")
    jnp = tpu.jnp
    vp, eff = jnp.asarray(inputs[2]), jnp.asarray(inputs[3])
    _, screen = tpu.common.vertex_stage(jnp.asarray(pos), vp, eff, W, H)
    ref = tpu.common.triangle_setup(screen, jnp.asarray(tri), eff, W, H,
                                    *tile)
    alive = np.asarray(ref["alive"])
    np.testing.assert_array_equal(rec["alive"].numpy(), alive)
    for k in ("tile_x0", "tile_y0", "tile_x1", "tile_y1"):
        np.testing.assert_array_equal(rec[k].numpy()[alive],
                                      np.asarray(ref[k])[alive], err_msg=k)


def test_cpu_tensors_take_the_twin(port, tpu):
    inputs = _inputs(tpu, "icosphere", "none")
    before = port.tracing.count("launches.front_end")
    a = _port_front(port, inputs)
    b = _port_front(port, inputs, fn=port.front.front_end_plain)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[1], b[1])
    assert port.tracing.count("launches.front_end") == before  # no kernel launched


def test_other_devices_raise(port, tpu):
    t = port.torch
    inputs = [t.from_numpy(a).to("meta") for a in _inputs(tpu, "icosphere",
                                                          "none")]
    with pytest.raises(ValueError, match="no kernel"):
        port.front.front_end(*inputs, width=W, height=H, tile_h=16,
                             tile_w=256)


@pytest.mark.cuda
@pytest.mark.parametrize("name,effect", [
    ("icosphere", "none"), ("soup", "voxelize"), ("soup+bad", "voxelize"),
    ("soup+bad", "none"), ("san_miguel_small", "none"), ("torus", "wave"),
])
def test_kernel_vs_twin_on_card(port, cuda_device, name, effect):
    t = port.torch
    inputs = [t.from_numpy(a).to(cuda_device)
              for a in _inputs(port, name, effect)]
    kw = dict(width=W, height=H, tile_h=16, tile_w=256)
    before = port.tracing.count("launches.front_end")
    ck, mk = port.front.front_end(*inputs, **kw)
    cp, mp = port.front.front_end_plain(*inputs, **kw)
    assert port.tracing.count("launches.front_end") == before + 1
    assert ck.shape == cp.shape and ck.stride() == cp.stride()
    assert t.equal(mk, mp)
    assert t.equal(t.isnan(ck), t.isnan(cp))
    keep = ~t.isnan(ck)
    gap = (ck[keep].view(t.int32).long() - cp[keep].view(t.int32).long())
    # Bitwise, except where sinf inputs differ on the wave frame (<= 1 ULP).
    assert int(gap.abs().max()) <= (1 if effect.startswith("wave") else 0)


def _mode_inputs(port, inputs, mode, device):
    """The front's inputs in ``mode`` on ``device``: the geometry of
    ``inputs`` and random kd, uv corners, TextureInfo or mip rows."""
    t = port.torch
    T = inputs[0].shape[2]
    rng = np.random.default_rng(3)
    rows = lambda *shape: t.from_numpy(
        rng.uniform(0, 1, shape).astype(np.float32)).to(device)
    kw = {}
    if mode != "base":
        kw["kd_rows"] = rows(T, 3)
    if mode.startswith("texf"):
        kw["uv_soa"] = rows(3, 2, T)
        kw["tex_rows" if mode == "texf" else "mip_rows"] = (
            rows(T, 3) if mode == "texf" else rows(T, 5))
    return [t.from_numpy(a).to(device) for a in inputs], kw


def _assert_rasters_take_table(port, table, mode):
    """The front's table has the layout both raster kernels read: (T, R),
    unit column stride, a row stride of R rounded up to 4 floats, a 16-byte
    aligned base; ``raster.kernel_table`` hands back the same storage and
    counts no copy."""
    R = port.raster.MODE_WIDTHS[mode]
    stride = {32: 32, 35: 36, 44: 44, 46: 48}[R]
    assert table.shape[1] == R and table.stride() == (stride, 1)
    assert table.data_ptr() % 16 == 0
    copies = port.raster.kernel_table.copies
    out, row_stride = port.raster.kernel_table(table)
    assert out.data_ptr() == table.data_ptr() and row_stride == stride
    assert port.raster.kernel_table.copies == copies
    # A chunk of rows, as the tile path's chunk loop slices it, too.
    assert port.raster.kernel_table(table[5:])[0].data_ptr() == \
        table[5:].data_ptr()


@pytest.mark.parametrize("tile", [(16, 256), (8, 8)])
@pytest.mark.parametrize("mode", ["base", "mat", "texf", "texf_mip"])
def test_rasters_take_the_twin_table_without_copy(port, mode, tile):
    inputs, kw = _mode_inputs(port, _inputs(port, "icosphere", "none"),
                              mode, "cpu")
    table, _ = port.front.front_end(*inputs, width=W, height=H,
                                    tile_h=tile[0], tile_w=tile[1], **kw)
    _assert_rasters_take_table(port, table, mode)
    # A table in another layout (a dense (T, 35) or (T, 46) one) is
    # copied, and the copy is counted.
    copies = port.raster.kernel_table.copies
    out, _ = port.raster.kernel_table(table.contiguous())
    assert port.raster.kernel_table.copies == copies + (table.shape[1] % 4
                                                        != 0)
    assert port.torch.equal(out, table)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(16, 256), (8, 8)])
@pytest.mark.parametrize("mode", ["base", "mat", "texf", "texf_mip"])
def test_rasters_take_the_kernel_table_on_card(port, cuda_device, mode,
                                               tile):
    # The kernel's table: the layout above, and bitwise the twin's.
    inputs, kw = _mode_inputs(port, _inputs(port, "san_miguel_small",
                                            "none"), mode, cuda_device)
    fkw = dict(width=W, height=H, tile_h=tile[0], tile_w=tile[1], **kw)
    table, meta = port.front.front_end(*inputs, **fkw)
    _assert_rasters_take_table(port, table, mode)
    plain, meta_p = port.front.front_end_plain(*inputs, **fkw)
    t = port.torch
    assert t.equal(meta, meta_p)
    assert t.equal(t.isnan(table), t.isnan(plain))
    keep = ~t.isnan(table)
    assert t.equal(table[keep].view(t.int32), plain[keep].view(t.int32))
