"""The tile path's binning stage (``binning.bin_tiles_meta``) and the
rasters' shading parameters (``raster.shading_inputs``) against the JAX
package, and ``cuda.render_frame``'s tile path through them.

- ``bin_tiles_meta`` on CPU tensors (its twin) against the JAX package's
  ``setup_from_meta`` + ``bin_triangles_dense`` +
  ``pallas_raster.occupied_worklist``, bitwise on every output: the whole
  (num_tiles, C) ``bin_rows`` (the slots past a tile's count included),
  the segments, the total, the needed capacities, the work list and its
  count, and the (2,) overflow report.
- ``shading_inputs`` against the params and light rows that
  ``pallas_raster.raster_shade_tiles`` builds before its pallas_call
  (pallas_raster.py:816-839), mirrored here op for op from the JAX
  package's own ``coverage_thresholds``. Bitwise, except the edge-melt
  threshold, whose sin comes from two libraries (XLA:CPU's and torch's):
  within 1 ULP.
- ``cuda.render_frame`` on the CPU at 256x192, in one chunk and in forced
  triangle chunks: the chunked frames equal the one-pass frame bitwise,
  and every frame is held to the JAX package's tile path within the pixel
  contract of tests/torch_parity.py (XLA:CPU contracts mul+add).

The longest bin list (``most``, folded by max into the accumulator's
last word) equals a direct count of the bins: each tile's alive
rects, on the dense and the flat layout (the flat one under pair
overflow too), and each micro cell's pairs.

The flat layout's span list (``spans``: its count, then a (tile, k)
entry for each of the tile raster's spans past a tile's first) and its
count in the accumulator's seventh word equal a loop over the tiles'
counts, with long, capped and pair-overflowing lists; the dense and
micro layouts write none.

The CUDA kernels (``csrc/bins.cu``, and ``csrc/sort.cu`` for the longest
list and the span list) are held to the twins on the same cases only
where a card exists."""

import numpy as np
import pytest

from tests.torch_bin_cases import (
    BIN_KEYS, META_CASES, MICRO_SORT_CASES, NTX, NTX_T, NTY, NTY_T,
    SPAN_CASES, _random_meta, meta_case, shading_case, sort_case, span_case,
    sort_pairs,
)
from tests.torch_parity import (  # noqa: F401 (fixtures)
    W, H, assert_frames_match, cuda_device, pixel_budget, port, tpu,
)

PAIR_CAP = 8192
DT = 1.0 / 60.0


def _jax_bins(tpu, meta, ntx, nty, tile_cap):
    """The JAX package's dense binning of the meta and its work list, as
    numpy, ``bin_rows`` cut to the grid's tiles (the JAX package pads it
    to 8-row blocks)."""
    jnp = tpu.jnp
    b = tpu.binning.bin_triangles_dense(
        tpu.binning.setup_from_meta(jnp.asarray(meta)), ntx, nty, PAIR_CAP,
        tile_cap)
    wl, k = tpu.pallas_raster.occupied_worklist(b["seg_count"])
    out = {key: np.asarray(b[key]) for key in BIN_KEYS[1:6]}
    out["bin_rows"] = np.asarray(b["bin_rows"])[:ntx * nty]
    out["worklist"], out["k"] = np.asarray(wl), np.asarray(k)
    out["overflow"] = np.stack([out["pair_needed"], out["tile_needed"]])
    return out


def _port_meta(port, meta, cut, device="cpu"):
    """The meta as the port's render_frame hands a chunk to the binning:
    a view of the frame's meta, not a copy."""
    m = port.torch.from_numpy(meta).to(device)
    return m if cut is None else m[:, cut[0]:cut[1]]


def _assert_bins_equal(a, b, what):
    for key in BIN_KEYS:
        x = np.asarray(a[key])
        y = b[key].cpu().numpy()
        assert x.shape == y.shape, (what, key, x.shape, y.shape)
        np.testing.assert_array_equal(x, y, err_msg=f"{what}: {key}")


@pytest.mark.parametrize("case", META_CASES)
def test_bin_tiles_meta_vs_jax(port, tpu, case):
    meta, ntx, nty, tile_cap, cut = meta_case(case)
    m = _port_meta(port, meta, cut)
    if cut is not None:
        assert m.stride(0) == meta.shape[1]  # read in place
        meta = meta[:, cut[0]:cut[1]]
    b = port.binning.bin_tiles_meta(m, ntx, nty, PAIR_CAP, tile_cap)
    assert b["layout"] == "dense"
    _assert_bins_equal(_jax_bins(tpu, meta, ntx, nty, tile_cap), b, case)
    C = (tile_cap + 127) // 128 * 128
    counts = b["seg_count"].numpy()
    if case == "tile_over_cap":
        assert int(b["tile_needed"]) > C and counts.max() == C
    else:
        assert int(b["tile_needed"]) == 0
    if case == "none_alive":
        assert int(b["k"]) == 0 and not counts.any()
        assert (b["bin_rows"].numpy() == meta.shape[1] - 1).all()


def test_bin_tiles_meta_layout_rule(port):
    # The same rule as bin_triangles: past DENSE_BINNING_OP_LIMIT the
    # flat layout, with its work list and overflow report.
    meta, ntx, nty, _, _ = meta_case("random0")
    m = port.torch.from_numpy(meta)
    big_cap = port.binning.DENSE_BINNING_OP_LIMIT // (ntx * nty * 700) + 8
    b = port.binning.bin_tiles_meta(m, ntx, nty, PAIR_CAP, big_cap)
    ref = port.binning.bin_triangles_sort(port.binning.setup_from_meta(m),
                                          ntx, nty, PAIR_CAP, big_cap)
    assert b["layout"] == "flat"
    for key in ("pair_tri", "seg_start", "seg_count", "total_pairs"):
        assert port.torch.equal(b[key], ref[key]), key
    wl, k = port.binning.occupied_worklist(ref["seg_count"])
    assert port.torch.equal(b["worklist"], wl) and int(b["k"]) == int(k)
    assert b["overflow"].tolist() == [0, 0]
    with pytest.raises(ValueError):
        port.binning.bin_tiles_meta(m[:3], ntx, nty, PAIR_CAP, 128)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_stripe_meta_bins_as_clipped_rects(port, n):
    # A tile stripe of a sharded render bins the meta with each
    # triangle's rows clipped to the stripe (parallel/sharding.py): the
    # same bins as the whole-frame rects clipped to the stripe's rows, in
    # both layouts, on every stripe.
    from compute_renderer_torch.parallel import sharding

    t = port.torch
    meta = t.from_numpy(_random_meta(np.random.default_rng(n), 700, NTX,
                                     NTY, span=6))
    rows = NTY // n
    for row0 in range(0, NTY, rows):
        setup = port.binning.setup_from_meta(meta)
        y0 = t.clamp(setup["tile_y0"] - row0, 0, rows).to(t.int32)
        y1 = t.clamp(setup["tile_y1"] - row0, 0, rows).to(t.int32)
        setup = dict(setup, tile_y0=y0, tile_y1=y1,
                     alive=setup["alive"] & (y1 > y0))
        stripe = sharding._stripe_meta(meta, row0, rows)
        for tile_cap in (128, port.binning.DENSE_BINNING_OP_LIMIT
                         // (NTX * rows * 700) + 8):
            want = port.binning.bin_triangles(setup, NTX, rows, PAIR_CAP,
                                              tile_cap)
            got = port.binning.bin_tiles_meta(stripe, NTX, rows, PAIR_CAP,
                                              tile_cap)
            assert got["layout"] == want["layout"]
            for key, a in want.items():
                if key != "layout":
                    assert t.equal(got[key], a), (row0, tile_cap, key)


def _jax_shading(tpu, eff, vpos, lwp, lc, li, y_offset):
    """pallas_raster.py:816-839 (raster_shade_tiles' params and light
    rows), op for op, from the JAX package's coverage_thresholds."""
    jnp = tpu.jnp
    f32 = jnp.float32
    eff, vpos = jnp.asarray(eff), jnp.asarray(vpos)
    threshold, melt = tpu.common.coverage_thresholds(eff)
    mirage = jnp.where(eff[0] == tpu.effects.EFFECT_MIRAGE, f32(1.0),
                       f32(0.0))
    params = jnp.stack([threshold, melt, mirage, eff[1], eff[2], eff[3],
                        eff[5], jnp.asarray(y_offset, f32), vpos[0],
                        vpos[1], vpos[2]])
    L = lwp.shape[0]
    lights = jnp.concatenate([jnp.asarray(lwp), jnp.asarray(lc),
                              jnp.asarray(li)[:, None],
                              jnp.zeros((L, 1), f32)], axis=1)
    return np.asarray(params), np.asarray(lights)


def _ulps(a, b):
    a = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    b = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(a - b)


@pytest.mark.parametrize("y_offset", [0, 96])
@pytest.mark.parametrize("effect", ["none", "voxelize", "edge_melt",
                                    "mirage"])
def test_shading_inputs_vs_jax(port, tpu, effect, y_offset):
    args = shading_case(tpu, effect)
    pa, la = _jax_shading(tpu, *args, y_offset)
    pb, lb = port.raster.shading_inputs(
        *(port.torch.from_numpy(a) for a in args), y_offset)
    assert pb.dtype == lb.dtype == port.torch.float32
    assert pb.shape == (11,) and lb.shape == (3, 8)
    np.testing.assert_array_equal(la, lb.numpy())
    pb = pb.numpy()
    exact = [i for i in range(11) if i != 1]
    np.testing.assert_array_equal(pa[exact], pb[exact])
    if effect == "edge_melt":
        assert np.isfinite(pb[1]) and _ulps(pa[1], pb[1]) <= 1
    else:
        np.testing.assert_array_equal(pa[1], pb[1])


def _suzanne_frame(pkg):
    """bench.py's scene at W x H in one package, advanced a few frames:
    (positions, normals, (T, 3) int32 tri, view_proj, view_position,
    light pos, color, intensity, effect) as numpy."""
    cc = pkg.scene.CameraConfig(distance=2.0,
                                mode=pkg.camera.CameraMode.FIRST_PERSON,
                                position=(0.0, 0.0, 3.0))
    scene = pkg.scene.Scene.from_config(
        pkg.scene.SceneConfig(model_path="suzanne.obj", camera_config=cc),
        W, H)
    for _ in range(2):
        u = scene.update(DT)
    mesh = scene.mesh
    return [np.asarray(a, np.float32) for a in (mesh.positions,
                                                mesh.normals)] + [
        mesh.indices.astype(np.int32).reshape(-1, 3)] + [
        np.asarray(a, np.float32) for a in (
            u.view_proj, u.view_position, u.light_world_pos, u.light_color,
            u.light_intensity, u.effect)]


@pytest.fixture(scope="module")
def suzanne(port):
    """The frame's inputs, and the port's one-pass frame of them (the two
    packages' scenes give the same numpy inputs)."""
    x = _suzanne_frame(port)
    t = [port.torch.from_numpy(np.ascontiguousarray(a)) for a in x]
    return x, t, port.cuda.render_frame(*t, width=W, height=H, path="tile")


@pytest.mark.parametrize("tri_chunk", [0, 300, 512])
def test_render_frame_tile_chunks_vs_jax(port, tpu, suzanne, tri_chunk):
    x, t, (r1, k1, o1) = suzanne
    T = x[2].shape[0]
    assert T > 2 * 512  # 300 and 512 give several chunks
    rb, kb, ob = port.cuda.render_frame(*t, width=W, height=H, path="tile",
                                        tri_chunk=tri_chunk)
    assert ob.tolist() == [0, 0]
    np.testing.assert_array_equal(r1.numpy(), rb.numpy())
    np.testing.assert_array_equal(k1.numpy(), kb.numpy())
    jnp = tpu.jnp
    pos, nrm = x[0], x[1]
    ra, ka, oa = tpu.backend.render_frame(
        jnp.asarray(pos), jnp.asarray(nrm),
        jnp.zeros((pos.shape[0], 2), jnp.float32),
        *(jnp.asarray(a) for a in x[2:]), width=W, height=H, path="tile",
        tri_chunk=tri_chunk, interpret=True)
    np.testing.assert_array_equal(np.asarray(oa), ob.numpy())
    assert_frames_match(np.asarray(ra), rb.numpy())
    ka, kb = np.asarray(ka).astype(np.int64), kb.numpy().astype(np.int64)
    assert int(((ka != 0xFFFFFFFF) != (kb != 0xFFFFFFFF)).sum()) <= \
        pixel_budget(H, W)
    assert (kb != 0xFFFFFFFF).sum() > 1000


# ---------------------------------------------------------------------------
# The longest bin list: the last word of the accumulator
# ---------------------------------------------------------------------------

LONGEST_LAYOUTS = ["dense", "flat", "flat_pair_overflow"]
# A longest list already in the word, from an earlier frame of the batch.
EARLIER = 9


def _direct_longest(meta, ntx, nty):
    """The most alive triangles whose tile rect holds one tile, counted
    tile by tile in numpy from the meta rows [x0, y0, rx, c]."""
    x0, y0, rx, c = (meta[i].astype(np.int64) for i in range(4))
    alive = c > 0
    x1 = x0 + np.where(alive, rx, 0)
    y1 = y0 + np.where(alive, c // np.maximum(rx, 1), 0)
    most = 0
    for jy in range(nty):
        for jx in range(ntx):
            hold = alive & (x0 <= jx) & (jx < x1) & (y0 <= jy) & (jy < y1)
            most = max(most, int(hold.sum()))
    return most


def _longest_acc(port, device="cpu"):
    acc = port.torch.zeros((port.binning.ACC_WORDS,),
                           dtype=port.torch.int64, device=device)
    acc[7] = EARLIER
    return acc


def _tile_layout(port, monkeypatch, layout):
    """The pair capacity of ``layout``, the flat ones forced by the dense
    rule's limit."""
    if layout != "dense":
        monkeypatch.setattr(port.binning, "DENSE_BINNING_OP_LIMIT", 0)
    return 16 if layout == "flat_pair_overflow" else PAIR_CAP


@pytest.mark.parametrize("layout", LONGEST_LAYOUTS)
@pytest.mark.parametrize("case", META_CASES)
def test_longest_list_is_the_largest_tile_count(port, monkeypatch, layout,
                                                case):
    # Tolerance: none; integers. The count is the unclamped one: over the
    # tile cap (tile_over_cap) and over the pair capacity alike.
    pair_cap = _tile_layout(port, monkeypatch, layout)
    meta, ntx, nty, tile_cap, cut = meta_case(case)
    m = _port_meta(port, meta, cut)
    if cut is not None:
        meta = meta[:, cut[0]:cut[1]]
    acc = _longest_acc(port)
    bins = port.binning.bin_tiles_meta(m, ntx, nty, pair_cap, tile_cap, acc)
    assert bins["layout"] == layout.split("_")[0]
    want = _direct_longest(meta, ntx, nty)
    assert int(bins["most"]) == want
    assert int(acc[7]) == max(EARLIER, want)
    if case == "tile_over_cap":
        assert want == int(bins["tile_needed"]) > tile_cap
    assert (int(bins["pair_needed"]) > 0) == (int(meta[3].sum()) > pair_cap)


def _micro_rows(port, name, device="cpu"):
    """A micro case's cover rows (c, rx, x0, y0), its pair capacity, and
    the largest count of its cells in the pair list the expansion
    writes (the first pair_cap pairs in triangle order)."""
    meta, ntx, nty, pair_cap, _ = sort_case("micro", name)
    keys, _, total = sort_pairs(meta, ntx, ntx * nty, pair_cap)
    n = min(total, pair_cap)
    most = int(np.bincount(keys[:n], minlength=1).max())
    rows = [port.torch.from_numpy(meta[i]).to(device) for i in (3, 2, 0, 1)]
    return rows, pair_cap, most


@pytest.mark.parametrize("name", MICRO_SORT_CASES)
def test_longest_list_is_the_largest_cell_count(port, name):
    rows, pair_cap, want = _micro_rows(port, name)
    acc = _longest_acc(port)
    bins = port.binning.bin_cells_sort_meta(*rows, NTX_T, NTY_T, pair_cap,
                                            acc)
    assert int(bins["most"]) == want
    assert int(acc[7]) == max(EARLIER, want)
    if name == "long":
        assert want > EARLIER


def _direct_spans(seg_count, span):
    """The span list's (tile, k) entries from the counts, tile by tile in
    Python: one for each k >= 1 with k span below the count."""
    return [(t, k) for t, c in enumerate(seg_count.tolist())
            for k in range(1, -(-c // span))]


@pytest.mark.parametrize("name", SPAN_CASES)
def test_span_list_is_the_long_tiles_windows(port, monkeypatch, name):
    # Tolerance: none; integers. The counts are the clamped ones.
    monkeypatch.setattr(port.binning, "DENSE_BINNING_OP_LIMIT", 0)
    meta, ntx, nty, pair_cap, tile_cap = span_case(name)
    acc = _longest_acc(port)
    acc[6] = 3  # an earlier frame's spans
    bins = port.binning.bin_tiles_meta(port.torch.from_numpy(meta), ntx,
                                       nty, pair_cap, tile_cap, acc)
    span = port.binning.TILE_SPAN
    want = _direct_spans(bins["seg_count"], span)
    extra = len(want)
    assert bins["layout"] == "flat"
    assert bins["spans"].dtype == port.torch.int32
    # The count, the entries by tile and span, then zeros up to the list's
    # room, ceil(pair_cap / span) entries.
    assert bins["spans"].tolist() == [extra] + [v for e in want for v in e] \
        + [0] * (2 * -(-pair_cap // span) - 2 * extra)
    assert int(acc[6]) == 3 + extra
    assert extra >= 2
    if name == "long":
        assert int(bins["seg_count"].max()) > 3 * span
    if name == "long_capped":
        assert int(bins["tile_needed"]) > tile_cap
    if name == "long_pair_overflow":
        assert int(bins["pair_needed"]) > pair_cap


def test_dense_and_micro_layouts_write_no_spans(port):
    meta, ntx, nty, pair_cap, tile_cap = span_case("long")
    acc = _longest_acc(port)
    bins = port.binning.bin_tiles_meta(port.torch.from_numpy(meta), ntx,
                                       nty, pair_cap, tile_cap, acc)
    assert bins["layout"] == "dense" and "spans" not in bins
    rows, cap, _ = _micro_rows(port, "long")
    bins = port.binning.bin_cells_sort_meta(*rows, NTX_T, NTY_T, cap, acc)
    assert "spans" not in bins
    assert int(acc[6]) == 0


# ---------------------------------------------------------------------------
# The kernels against the twins, on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("case", META_CASES)
def test_card_bin_tiles_dense_matches_twin(port, cuda_device, case):
    meta, ntx, nty, tile_cap, cut = meta_case(case)
    before = port.tracing.count("launches.bin_tiles_meta")
    b = port.binning.bin_tiles_meta(_port_meta(port, meta, cut, cuda_device),
                                    ntx, nty, PAIR_CAP, tile_cap)
    assert port.tracing.count("launches.bin_tiles_meta") == before + 1
    ref = port.binning.bin_tiles_meta(_port_meta(port, meta, cut), ntx, nty,
                                      PAIR_CAP, tile_cap)
    port.torch.cuda.synchronize()
    _assert_bins_equal({k: ref[k].numpy() for k in BIN_KEYS}, b, case)


@pytest.mark.cuda
@pytest.mark.parametrize("y_offset", [0, 96])
@pytest.mark.parametrize("effect", ["none", "voxelize", "edge_melt",
                                    "mirage"])
def test_card_shading_params_matches_twin(port, cuda_device, effect,
                                          y_offset):
    args = [port.torch.from_numpy(a) for a in shading_case(port, effect)]
    before = port.tracing.count("launches.shading_inputs")
    pk, lk = port.raster.shading_inputs(
        *(a.to(cuda_device) for a in args), y_offset)
    assert port.tracing.count("launches.shading_inputs") == before + 1
    pp, lp = port.raster.shading_inputs_plain(
        *(a.to(cuda_device) for a in args), y_offset)
    assert port.torch.equal(pk.view(port.torch.int32),
                            pp.view(port.torch.int32))
    assert port.torch.equal(lk, lp)


@pytest.mark.cuda
@pytest.mark.parametrize("tri_chunk", [300, 512])
def test_card_render_frame_tile_matches_cpu(port, cuda_device, suzanne,
                                            tri_chunk):
    # On the card: chunked frames equal the one-pass frame bitwise, and
    # the one-pass frame is the CPU twins' within 1 LSB.
    _, t, (r1, _, _) = suzanne
    t = [a.to(cuda_device) for a in t]
    ra, ka, oa = port.cuda.render_frame(*t, width=W, height=H, path="tile")
    rb, kb, ob = port.cuda.render_frame(*t, width=W, height=H, path="tile",
                                        tri_chunk=tri_chunk)
    assert oa.tolist() == ob.tolist() == [0, 0]
    i32 = port.torch.int32
    assert port.torch.equal(ra, rb)
    assert port.torch.equal(ka.view(i32), kb.view(i32))
    assert_frames_match(r1.numpy(), ra.cpu().numpy(), lsb=1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", LONGEST_LAYOUTS)
@pytest.mark.parametrize("case", META_CASES)
def test_card_longest_list_matches_twin(port, cuda_device, monkeypatch,
                                        layout, case):
    # bin_scan_kernel (dense) and bin_sort_scan_kernel (flat) fold the
    # largest count into the word, and write it to scal[4], as the twins.
    pair_cap = _tile_layout(port, monkeypatch, layout)
    meta, ntx, nty, tile_cap, cut = meta_case(case)
    got, want = _longest_acc(port, cuda_device), _longest_acc(port)
    bk = port.binning.bin_tiles_meta(_port_meta(port, meta, cut, cuda_device),
                                     ntx, nty, pair_cap, tile_cap, got)
    bp = port.binning.bin_tiles_meta(_port_meta(port, meta, cut), ntx, nty,
                                     pair_cap, tile_cap, want)
    assert bk["layout"] == bp["layout"] == layout.split("_")[0]
    assert int(bk["most"]) == int(bp["most"])
    assert got.cpu().tolist() == want.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("name", MICRO_SORT_CASES)
def test_card_longest_cell_list_matches_twin(port, cuda_device, name):
    rows, pair_cap, most = _micro_rows(port, name)
    got, want = _longest_acc(port, cuda_device), _longest_acc(port)
    bk = port.binning.bin_cells_sort_meta(
        *(r.to(cuda_device) for r in rows), NTX_T, NTY_T, pair_cap, got)
    bp = port.binning.bin_cells_sort_meta(*rows, NTX_T, NTY_T, pair_cap,
                                          want)
    assert int(bk["most"]) == int(bp["most"]) == most
    assert got.cpu().tolist() == want.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("name", SPAN_CASES)
def test_card_span_list_matches_twin(port, cuda_device, monkeypatch, name):
    # bin_sort_scan_kernel writes the span list in the sort's cleared
    # scratch and adds its entries to the seventh word, as the twin; the
    # micro layout writes none.
    monkeypatch.setattr(port.binning, "DENSE_BINNING_OP_LIMIT", 0)
    meta, ntx, nty, pair_cap, tile_cap = span_case(name)
    got, want = _longest_acc(port, cuda_device), _longest_acc(port)
    for _ in range(2):  # a second call finds the scratch written before
        bk = port.binning.bin_tiles_meta(
            port.torch.from_numpy(meta).to(cuda_device), ntx, nty, pair_cap,
            tile_cap, got)
    for _ in range(2):
        bp = port.binning.bin_tiles_meta(port.torch.from_numpy(meta), ntx,
                                         nty, pair_cap, tile_cap, want)
    assert bk["spans"].cpu().tolist() == bp["spans"].tolist()
    assert got.cpu().tolist() == want.tolist()
    assert int(want[6]) > 0
    rows, cap, _ = _micro_rows(port, "long", cuda_device)
    got = _longest_acc(port, cuda_device)
    micro = port.binning.bin_cells_sort_meta(*rows, NTX_T, NTY_T, cap, got)
    assert "spans" not in micro and int(got[6]) == 0
