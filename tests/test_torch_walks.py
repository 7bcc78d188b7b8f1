"""The two rasters' decompositions on the card, held to the unchanged
twins: the tile raster's sub-rectangle walk with its rectangle cull
(``raster.cull_rect_plain``, ``raster.raster_shade_subtiles_plain``) and
the micro raster's span split with its packed (key, pair) merge
(``micro.raster_shade_micro_spans_plain``).

- The cull is held against an exhaustive float32 evaluation of every
  sample of the rectangle, as the walk evaluates it, on adversarial rows
  (edge-exact integer triangles, huge coordinates, NaN, infinities, -0.0,
  subnormals, mirage sample positions, negative and NaN bounds): it never
  drops a row that covers a sample. This is exact, no tolerance: the cull
  evaluates the walk's own float operations at the highest corner.
- The mirrors equal ``raster_shade_tiles_plain`` and
  ``raster_shade_micro_plain`` bitwise in every mode (keys, ids, RGBA and
  G-buffers), on the port's own chain and on chip_smoke.py's phase-13
  stress cases, the micro split at tiny spans so that cells split.
- Against the JAX package's ``pallas_micro.raster_shade_micro``
  (interpret mode) on a frame with long cells, the tolerance of
  tests/test_torch_micro.py: XLA:CPU contracts mul+add into FMA inside
  the interpret-mode kernel, so at most max(2, H*W/500) pixels may differ
  in coverage or by more than 1 LSB, and keys by more than 1 ULP.

The kernels themselves are held against the twins on the stress cases
only where a card exists (``-m cuda``)."""

import os
import sys

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from tests.torch_parity import (  # noqa: F401 (fixtures)
    W, H, assert_frames_match, cuda_device, port, tpu,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODES = ("base", "mat", "texf", "vis", "texf_mip")
EFFECTS = {
    "none": [0.0, 0.0, 0.0, 0.0, 0.0, 0.0],
    "edge_melt": [2.0, 0.25, 0.8, 0.0, 0.0, 2.1],
    "voxelize": [3.0, 0.3, 0.0, 0.0, 0.0, 0.4],
    "mirage": [4.0, 0.6, 0.05, 0.3, 1.0, 1.7],
}
LIGHTS = (np.array([[0.0, 0.0, 5.0], [-5.0, 3.0, 0.0]], np.float32),
          np.array([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5]], np.float32),
          np.array([1.0, 0.5], np.float32))


def _smoke():
    """chip_smoke.py, whose phase-13 stress cases the tests share (it
    imports only the standard library at module level)."""
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    import chip_smoke

    return chip_smoke


# --- the cull ---------------------------------------------------------------

def _covers_any(port, rows, px, py, cov_min):
    """Per row of (N, R) rows: does any of the samples (px, py) (float32,
    (S,)) pass the walk's coverage test, evaluated as the kernels do."""
    t = port.torch
    r = lambda c: rows[:, c:c + 1]
    dx = px[None, :] - r(30)
    dy = py[None, :] - r(31)
    bc1 = r(0) + r(1) * dx + r(2) * dy
    bc2 = r(3) + r(4) * dx + r(5) * dy
    bc3 = r(6) + r(7) * dx + r(8) * dy
    z = r(9) + r(10) * dx + r(11) * dy
    cov = ((bc1 >= cov_min) & (bc2 >= cov_min) & (bc3 >= cov_min)
           & t.isfinite(z))
    return cov.any(1)


def _samples(port, x0, y0, w, h, mirage):
    """A w x h block of integer samples at (x0, y0), optionally moved by
    the mirage warp as the kernels move them; float32 (px, py) and the
    rectangle (x lo, x hi, y lo, y hi) of the non-NaN ones."""
    t = port.torch
    xs = (t.arange(w, dtype=t.float32) + np.float32(x0)).repeat(h)
    ys = (t.arange(h, dtype=t.float32) + np.float32(y0)).repeat_interleave(w)
    if mirage is not None:
        a, f, ph, tm = (t.tensor(v, dtype=t.float32) for v in mirage)
        xs = xs + a * t.sin(f * xs + tm + ph)
        ys = ys + a * t.cos(f * ys + tm + ph)
    ok_x, ok_y = ~t.isnan(xs), ~t.isnan(ys)
    nan = t.tensor(float("nan"))
    rect = [xs[ok_x].min() if ok_x.any() else nan,
            xs[ok_x].max() if ok_x.any() else nan,
            ys[ok_y].min() if ok_y.any() else nan,
            ys[ok_y].max() if ok_y.any() else nan]
    return xs, ys, rect


def _rows_from_corners(port, corners, depth):
    """(N, 32) table rows from (N, 3, 2) screen corners and (N, 3) depths
    (the front's coefficients), normals and world positions unit."""
    t = port.torch
    c = t.from_numpy(np.asarray(corners, np.float32))
    z = t.from_numpy(np.asarray(depth, np.float32))
    one = t.ones(c.shape[0])
    screen = tuple((c[:, k, 0], c[:, k, 1], z[:, k], one) for k in range(3))
    soa = tuple((one, one, one) for _ in range(3))
    return t.stack(port.raster.tri_table_columns(screen, soa, soa), dim=1)


SPECIAL = [0.0, -0.0, 1e-45, -1e-45, 1e-38, 1.0, -1.0, 0.5, 3.0, -7.25,
           1e30, -1e30, 3.4e38, -3.4e38, float("inf"), float("-inf"),
           float("nan")]


def _adversarial_rows(port, rng, x0, y0, w, h, n=256):
    """Rows aimed at the rectangle: edge-exact integer triangles with
    corners on and around its borders, the same far away (1e6) and at
    huge depth, and rows of special values (NaN, infinities, -0.0,
    subnormals, huge) patched into those."""
    corners = rng.integers(-3, 4, (n, 3, 2)) + np.array([x0, y0])
    corners[: n // 4] += rng.integers(0, 2, (n // 4, 1, 2)) * np.array(
        [w, h])
    depth = rng.uniform(-1, 1, (n, 3))
    rows = [_rows_from_corners(port, corners, depth),
            _rows_from_corners(port, corners * 64.0 + 1e6, depth * 1e30)]
    t = port.torch
    special = rows[0].clone()
    pick = rng.integers(0, len(SPECIAL), (n, 4))
    cols = rng.integers(0, 12, (n, 4))
    cols[:, 3] = rng.choice([1, 2, 30, 31], n)
    values = t.tensor(SPECIAL, dtype=t.float32)
    for k in range(4):
        special[t.arange(n), t.from_numpy(cols[:, k])] = values[pick[:, k]]
    rows.append(special)
    return t.cat(rows)


@pytest.mark.parametrize("cov_min", [0.0, -0.0, -0.3, 0.2, 1e-7, -1e30,
                                     float("-inf"), float("nan")])
@pytest.mark.parametrize("mirage", [None, (0.6, 0.05, 0.3, 1.7),
                                    (3.0, 2.0, 0.1, 0.0)])
def test_cull_never_drops_a_covered_row(port, cov_min, mirage):
    t = port.torch
    rng = np.random.default_rng(31)
    culled = covered = 0
    for x0, y0, w, h in ((32, 16, 8, 8), (0, 0, 32, 16), (224, 48, 8, 8),
                         (-5, 7, 1, 1), (100000, 20, 8, 4)):
        px, py, rect = _samples(port, x0, y0, w, h, mirage)
        rows = _adversarial_rows(port, rng, x0, y0, w, h)
        bound = t.tensor(cov_min, dtype=t.float32)
        keep = port.raster.cull_rect_plain(rows, *rect, bound)
        cov = _covers_any(port, rows, px, py, bound)
        assert not bool((cov & ~keep).any()), (x0, y0, w, h)
        culled += int((~keep).sum())
        covered += int(cov.sum())
    if cov_min == cov_min and cov_min > -1e29:  # the cull bites
        assert culled > 0 and covered > 0


_FLOATS = st.one_of(
    st.sampled_from(SPECIAL),
    st.floats(-1e4, 1e4, width=32),
    st.floats(width=32, allow_nan=True, allow_infinity=True))


@settings(max_examples=300, deadline=None, derandomize=True,
          suppress_health_check=[HealthCheck.too_slow])
@given(corners=st.lists(st.tuples(st.integers(-6, 40), st.integers(-6, 24)),
                        min_size=3, max_size=3),
       depth=st.lists(st.floats(-2, 2, width=32), min_size=3, max_size=3),
       patch=st.lists(st.tuples(st.integers(0, 31), _FLOATS), max_size=3),
       origin=st.tuples(st.integers(0, 32), st.integers(0, 16)),
       size=st.tuples(st.integers(1, 8), st.integers(1, 8)),
       cov_min=st.one_of(st.sampled_from([0.0, -0.0, -0.25]),
                         st.floats(-1, 1, width=32)),
       mirage=st.booleans())
def test_cull_property(port, corners, depth, patch, origin, size, cov_min,
                       mirage):
    # Any triangle (integer corners, so edges pass through samples), with
    # up to three columns replaced by arbitrary floats, against any block
    # of samples: a row that covers a sample is kept.
    t = port.torch
    rows = _rows_from_corners(port, [corners], [depth])
    for col, value in patch:
        rows[0, col] = value
    px, py, rect = _samples(port, *origin, *size,
                            (0.6, 0.05, 0.3, 1.7) if mirage else None)
    bound = t.tensor(cov_min, dtype=t.float32)
    keep = port.raster.cull_rect_plain(rows, *rect, bound)
    if bool(_covers_any(port, rows, px, py, bound)[0]):
        assert bool(keep[0])


def test_cull_keeps_non_finite_rectangles(port):
    t = port.torch
    rows = _rows_from_corners(port, [[(0, 0), (1, 0), (0, 1)]] * 3,
                              [[0.5] * 3] * 3)
    bound = t.tensor(0.0)
    far = (t.tensor(500.0), t.tensor(501.0), t.tensor(500.0),
           t.tensor(501.0))
    assert not bool(port.raster.cull_rect_plain(rows, *far, bound).any())
    for rect in ((t.tensor(float("nan")),) * 4,
                 (t.tensor(float("-inf")), *far[1:]),
                 (*far[:3], t.tensor(float("inf")))):
        assert bool(port.raster.cull_rect_plain(rows, *rect, bound).all())


def test_mirrors_use_the_kernels_constants(port):
    # The torch mirrors cut tiles and segments as the kernels do: their
    # constants are the sources' own.
    import re

    def const(name, symbol):
        path = os.path.join(ROOT, "compute_renderer_torch", "csrc", name)
        with open(path) as fh:
            return int(re.search(rf"constexpr int {symbol} = (\d+);",
                                 fh.read()).group(1))

    assert port.raster.SUB_TALL == (const("raster.cu", "SUB_H_TALL"),
                                    const("raster.cu", "SUB_W_TALL"))
    assert port.raster.SUB_SHORT == (const("raster.cu", "SUB_H_SHORT"),
                                     const("raster.cu", "SUB_W_SHORT"))
    assert port.raster.PATCH == const("raster.cu", "PATCH")
    # The bin sort and the raster share one span length, the twins'.
    assert port.binning.TILE_SPAN == const("tile_span.cuh", "TILE_SPAN")
    for name in ("raster.cu", "sort.cu"):
        with open(os.path.join(ROOT, "compute_renderer_torch", "csrc",
                               name)) as fh:
            assert '#include "tile_span.cuh"' in fh.read()
    assert port.raster.sub_shape(16) == port.raster.SUB_TALL
    assert port.raster.sub_shape(8) == port.raster.SUB_SHORT
    assert port.micro.SPAN == const("micro.cu", "SPAN")
    assert port.micro.WIDE == const("micro.cu", "WIDE")


# --- the mirrors against the unchanged twins -----------------------------

def _mode_table(port, base, mode, rng):
    """The base table widened to ``mode``'s columns with random values
    (the walk never reads them; the epilogue copies and interpolates)."""
    t = port.torch
    extra = port.raster.MODE_WIDTHS[mode] - base.shape[1]
    return t.cat([base, t.from_numpy(
        rng.uniform(0, 1, (base.shape[0], extra)).astype(np.float32))], 1)


def _port_chain(port, effect, tile, layout=None, name="icosphere"):
    """The port's own front chain on a procedural mesh at W x H: the
    32-column table, bins (tile layout, or 8x8 cells when ``layout`` is
    None) and the shading inputs."""
    t = port.torch
    mesh = (port.procedural.icosphere(3) if name == "icosphere"
            else port.procedural.make_model(name))
    tri = t.from_numpy(mesh.indices.astype(np.int32).reshape(-1, 3))
    u = port.camera.Camera.first_person([0.1, 0.05, 3.0],
                                        aspect=W / H).uniform()
    eff = t.tensor(EFFECTS[effect], dtype=t.float32)
    world, screen = port.common.vertex_stage(
        t.from_numpy(mesh.positions), t.from_numpy(u.view_proj), eff, W, H)
    setup = port.common.triangle_setup(screen, tri, eff, W, H, *tile)
    table = port.raster.build_tri_table(screen, tri,
                                        t.from_numpy(mesh.normals), world)
    ntx, nty = (W + tile[1] - 1) // tile[1], (H + tile[0] - 1) // tile[0]
    padded = (nty * tile[0], ntx * tile[1])
    if layout is None:
        ntx, nty = (W + 127) // 128, (H + 7) // 8
        bins = port.binning.bin_cells_sort(setup, ntx, nty, 65536)
        padded = (nty * 8, ntx * 128)
    else:
        need = port.binning.exact_tile_counts(setup, ntx, nty)
        binner = (port.binning.bin_triangles_dense if layout == "dense"
                  else port.binning.bin_triangles_sort)
        bins = binner(setup, ntx, nty, max(int(need.sum()), 1),
                      max(int(need.max()), 1))
    params, lights = port.raster.shading_inputs(
        eff, t.from_numpy(np.asarray(u.view_position, np.float32)),
        *[t.from_numpy(a) for a in LIGHTS])
    return table, bins, params, lights, padded


def _equal(port, a, b):
    """Two (out, key) pairs bitwise (float outputs by their bits)."""
    t = port.torch
    bits = lambda x: x.view(t.int32) if x.dtype == t.float32 else x
    return (bits(a[0]).shape == bits(b[0]).shape
            and t.equal(bits(a[0]), bits(b[0])) and t.equal(a[1], b[1]))


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("effect,tile,layout", [
    ("none", (16, 256), "dense"), ("mirage", (16, 256), "flat"),
    ("voxelize", (8, 128), "flat"), ("edge_melt", (32, 128), "dense"),
    ("none", (24, 40), "flat"),
])
def test_subtiles_equal_tile_twin(port, mode, effect, tile, layout):
    base, bins, params, lights, (hp, wp) = _port_chain(port, effect, tile,
                                                       layout)
    table = _mode_table(port, base, mode, np.random.default_rng(7))
    data = bins["bin_rows" if layout == "dense" else "pair_tri"]
    args = (table, data, bins["seg_start"], bins["seg_count"], params,
            lights)
    kw = dict(height_padded=hp, width_padded=wp, tile_h=tile[0],
              tile_w=tile[1], layout=layout, mode=mode)
    stats = {}
    sub = port.raster.raster_shade_subtiles_plain(*args, stats=stats, **kw)
    assert _equal(port, sub, port.raster.raster_shade_tiles_plain(*args,
                                                                  **kw))
    assert int((sub[1] != -1).sum()) > 0
    # The cull bites: fewer samples walked than the unculled walk's.
    assert 0 < stats["samples_walked"] < stats["samples_unculled"]
    assert stats["patch_survivors"] >= stats["pairs"] > 0


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("effect,tile,layout,span", [
    ("none", (8, 128), "flat", 3), ("mirage", (8, 128), "flat", 1),
    ("voxelize", (16, 256), "flat", 5), ("none", (16, 256), "dense", 2),
    ("edge_melt", (8, 128), "dense", 4), ("none", (24, 40), "flat", 2),
])
def test_subtile_spans_equal_tile_twin(port, monkeypatch, mode, effect,
                                       tile, layout, span):
    # Lists cut into spans of a few entries (the kernel's 256 never binds
    # on these frames): the flat layout's tiles split, each span walks its
    # positions and the spans merge by the packed (key, position) minimum;
    # the dense layout walks every list whole. Both sub-rectangle shapes.
    base, bins, params, lights, (hp, wp) = _port_chain(port, effect, tile,
                                                       layout)
    table = _mode_table(port, base, mode, np.random.default_rng(9))
    data = bins["bin_rows" if layout == "dense" else "pair_tri"]
    args = (table, data, bins["seg_start"], bins["seg_count"], params,
            lights)
    kw = dict(height_padded=hp, width_padded=wp, tile_h=tile[0],
              tile_w=tile[1], layout=layout, mode=mode)
    stats = {}
    monkeypatch.setattr(port.binning, "TILE_SPAN", span)
    sub = port.raster.raster_shade_subtiles_plain(*args, stats=stats, **kw)
    assert _equal(port, sub, port.raster.raster_shade_tiles_plain(*args,
                                                                  **kw))
    assert int((sub[1] != -1).sum()) > 0
    assert (stats["spans"] > 0) == (layout == "flat")
    if layout == "flat":
        # The twin's span list counts the same spans at its own length.
        assert stats["spans"] == int(port.binning.span_list_plain(
            bins["seg_count"], data.shape[0])[0])


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("effect,span", [("none", 1), ("mirage", 4),
                                         ("voxelize", 3), ("none", 256)])
def test_micro_spans_equal_micro_twin(port, mode, effect, span):
    base, bins, params, lights, (hp, wp) = _port_chain(port, effect, (8, 8))
    assert int(bins["seg_count"].max()) > 4  # some cells split at span 4
    table = _mode_table(port, base, mode, np.random.default_rng(8))
    args = (table, bins["pair_tri"], bins["seg_start"], bins["seg_count"],
            params, lights)
    kw = dict(height_padded=hp, width_padded=wp, mode=mode)
    spans = port.micro.raster_shade_micro_spans_plain(*args, span=span, **kw)
    assert _equal(port, spans, port.micro.raster_shade_micro_plain(*args,
                                                                   **kw))
    assert int((spans[1] != -1).sum()) > 0


@pytest.mark.parametrize("kind", ["duplicates", "nan_zero", "edges",
                                  "edges+mirage"])
def test_stress_cases_on_mirrors(port, kind):
    # chip_smoke.py's phase-13 inputs at a span of 4: the duplicates' equal
    # keys straddle spans, NaN / inf rows and -0.0 depth planes sit in split
    # cells, edges run along the sub-rectangle borders.
    smoke = _smoke()
    x = smoke.stress_inputs(kind, "cpu", 4)
    kw = dict(height_padded=smoke.STRESS_H, width_padded=smoke.STRESS_W)
    for mode in MODES:
        table = x["tables"][mode]
        for layout, (data, starts, counts) in x["tile"].items():
            args = (table, data, starts, counts, x["params"],
                    x["light_rows"])
            tkw = dict(tile_h=16, tile_w=256, layout=layout, mode=mode, **kw)
            assert _equal(port,
                          port.raster.raster_shade_subtiles_plain(*args,
                                                                  **tkw),
                          port.raster.raster_shade_tiles_plain(*args, **tkw))
        args = (table, *x["micro"][:3], x["params"], x["light_rows"])
        plain = port.micro.raster_shade_micro_plain(*args, mode=mode, **kw)
        assert _equal(port, plain, port.micro.raster_shade_micro_spans_plain(
            *args, mode=mode, span=4, **kw))
        assert int((plain[1] != -1).sum()) > 0
    assert x["densest"] > 4


@pytest.mark.parametrize("tile", [(8, 128), (16, 256)])
@pytest.mark.parametrize("kind", ["duplicates", "nan_zero", "edges+mirage"])
def test_stress_spans_on_tile_mirror(port, monkeypatch, kind, tile):
    # The phase-13 cases at both tile shapes, the lists cut at spans of 4:
    # the duplicates' equal keys straddle every span border, and the
    # lowest list position must win across the merge.
    smoke = _smoke()
    x = smoke.stress_inputs(kind, "cpu", 4, tile=tile)
    kw = dict(height_padded=smoke.STRESS_H, width_padded=smoke.STRESS_W,
              tile_h=tile[0], tile_w=tile[1])
    monkeypatch.setattr(port.binning, "TILE_SPAN", 4)
    for mode in MODES:
        for layout, (data, starts, counts) in x["tile"].items():
            args = (x["tables"][mode], data, starts, counts, x["params"],
                    x["light_rows"])
            stats = {}
            sub = port.raster.raster_shade_subtiles_plain(
                *args, layout=layout, mode=mode, stats=stats, **kw)
            assert _equal(port, sub, port.raster.raster_shade_tiles_plain(
                *args, layout=layout, mode=mode, **kw))
            assert (stats["spans"] > 0) == (layout == "flat")
    assert x["longest"] > 4 * 4


def test_micro_spans_vs_pallas(port, tpu):
    # A frame whose cells split at span 4 (the grid mesh: the densest cell
    # holds dozens of pairs), against the JAX package's micro raster.
    from tests.test_torch_micro import (
        NTX, NTY, _assert_keys_close, _case, _jax_micro, _jax_stage, _unpack,
    )

    c = _case(tpu, "grid", "none")
    table, _, bins = _jax_stage(tpu, c)
    assert int(bins["seg_count"].max()) > 4
    ra, ka = _jax_micro(tpu, table, bins, c)
    t = port.torch
    dev = lambda a: t.from_numpy(np.ascontiguousarray(a))
    params, lights = port.raster.shading_inputs(
        dev(c["eff"]), dev(c["vpos"]), *[dev(a) for a in c["lights"]])
    rb, kb = port.micro.raster_shade_micro_spans_plain(
        dev(table), *[dev(bins[k]) for k in ("pair_tri", "seg_start",
                                             "seg_count")],
        params, lights, height_padded=NTY * 8, width_padded=NTX * 128,
        span=4)
    rb = rb.numpy().view(np.uint32)
    kb = kb.numpy().view(np.uint32)
    assert_frames_match(_unpack(ra), _unpack(rb), lsb=1)
    _assert_keys_close(ka, kb, ulp=1)


# --- the kernels, on the card -------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["duplicates", "nan_zero", "edges",
                                  "edges+mirage"])
def test_stress_cases_on_card(port, cuda_device, kind):
    # The kernels against the unchanged twins on the same card tensors, at
    # the kernel's own span: every mode bitwise (RGBA within 1 LSB).
    t = port.torch
    smoke = _smoke()
    x = smoke.stress_inputs(kind, cuda_device, port.micro.SPAN)
    kw = dict(height_padded=smoke.STRESS_H, width_padded=smoke.STRESS_W)
    for mode in MODES:
        table = x["tables"][mode]
        for layout, (data, starts, counts) in x["tile"].items():
            rk, kk = port.raster.raster_shade_tiles(
                table, data, starts, counts, x["effect"], x["vpos"],
                *x["lights"], tile_h=16, tile_w=256, layout=layout,
                mode=mode, **kw)
            rp, kp = port.raster.raster_shade_tiles_plain(
                table, data, starts, counts, x["params"], x["light_rows"],
                tile_h=16, tile_w=256, layout=layout, mode=mode, **kw)
            smoke.compare_outputs(f"{kind} tile {mode} {layout}", mode, rk,
                                  kk, rp, kp)
        for _ in range(2):  # the merge state is left clear for the next
            rk, kk = port.micro.raster_shade_micro(
                table, *x["micro"], x["effect"], x["vpos"], *x["lights"],
                mode=mode, **kw)
            rp, kp = port.micro.raster_shade_micro_plain(
                table, *x["micro"][:3], x["params"], x["light_rows"],
                mode=mode, **kw)
            smoke.compare_outputs(f"{kind} micro {mode}", mode, rk, kk, rp,
                                  kp)
        words, arrivals = port.common.merge_scratch(
            t.device(cuda_device), smoke.STRESS_H, smoke.STRESS_W)
        assert bool((words == -1).all()) and not bool(arrivals.any())
    assert x["densest"] > 20 * port.micro.SPAN or kind != "duplicates"


# Per stress case, the span argument of its triangles that gives 8x128
# tile lists of 3-6 kernel spans (duplicates, nan_zero) and the edges'
# fixed lists, which run along the 8x32 and 16x16 block borders. The
# 4x64 tiles are cut by 8x32 sub-rectangles that reach past the tile.
CARD_SPAN_CASES = {"duplicates": 50, "nan_zero": 300, "edges": 4,
                   "edges+mirage": 4}


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [(8, 128), (16, 256), (4, 64)])
@pytest.mark.parametrize("kind", list(CARD_SPAN_CASES))
def test_stress_spans_on_card(port, cuda_device, kind, tile):
    # The tile kernel against the unchanged twin with the flat layout's
    # span list: every mode bitwise (RGBA within 1 LSB), twice, the merge
    # words and counters left clear after each launch.
    t = port.torch
    smoke = _smoke()
    x = smoke.stress_inputs(kind, cuda_device, CARD_SPAN_CASES[kind],
                            tile=tile)
    kw = dict(height_padded=smoke.STRESS_H, width_padded=smoke.STRESS_W,
              tile_h=tile[0], tile_w=tile[1])
    data, starts, counts = x["tile"]["flat"]
    spans = port.binning.span_list_plain(counts, data.shape[0])
    extra = int(spans[0])
    if kind in ("duplicates", "nan_zero") and tile != (4, 64):
        span = port.binning.TILE_SPAN
        assert 3 * span <= x["longest"] <= 6 * span
        assert extra > 0
    for mode in MODES:
        table = x["tables"][mode]
        for _ in range(2):
            rk, kk = port.raster.raster_shade_tiles(
                table, data, starts, counts, x["effect"], x["vpos"],
                *x["lights"], layout="flat", mode=mode,
                worklist=port.binning.occupied_worklist(counts),
                spans=spans, **kw)
            rp, kp = port.raster.raster_shade_tiles_plain(
                table, data, starts, counts, x["params"], x["light_rows"],
                layout="flat", mode=mode, **kw)
            smoke.compare_outputs(f"{kind} tile {tile} {mode} spans", mode,
                                  rk, kk, rp, kp)
            words, arrivals = port.common.merge_scratch(
                t.device(cuda_device), smoke.STRESS_H, smoke.STRESS_W)
            assert bool((words == -1).all()) and not bool(arrivals.any())


def _cell_frame(port, device):
    """The structured_tex_aniso.batch cell's first frame through the
    front on the card: the 36k textured scene at its spawn, texf_mip
    under the anisotropic filter, binned flat at 8x128 (table, bins,
    params, lights, frame size)."""
    smoke = _smoke()
    from compute_renderer_torch import CameraConfig, Scene, SceneConfig
    from compute_renderer_torch.io import objgen

    objgen.ensure_textured_scene()
    scene = Scene.from_config(SceneConfig(
        model_path=objgen.STRUCTURED_TEX_NAME, enable_textures=True,
        camera_config=CameraConfig.first_person(smoke.STRUCTURED_EYE)),
        smoke.W, smoke.H)
    x = smoke.frame_inputs(scene, device, tex_filter="anisotropic")
    table, meta = port.front.front_end(
        x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"], width=smoke.W,
        height=smoke.H, tile_h=8, tile_w=128,
        **smoke.front_modes(x, "texf_mip"))
    ntx, nty = smoke.W // 128, smoke.H // 8
    need = port.binning.exact_tile_counts(
        port.binning.setup_from_meta(meta), ntx, nty)
    bins = port.binning.bin_tiles_meta(meta, ntx, nty, int(need.sum()),
                                       int(need.max()))
    params, lights = port.raster.shading_inputs(x["eff"], x["vpos"],
                                                x["lwp"], x["lc"], x["li"])
    return table, bins, params, lights, x, (nty * 8, ntx * 128)


@pytest.mark.cuda
def test_cell_frame_spans_on_card(port, cuda_device):
    # The cell's frame (its longest list several spans long) through the
    # kernel with the bin sort's span list, against the twin: keys and
    # the defined G-buffer planes bitwise, in texf_mip and base.
    table, bins, params, lights, x, (hp, wp) = _cell_frame(port,
                                                           cuda_device)
    assert bins["layout"] == "flat"
    assert int(bins["seg_count"].max()) > 3 * port.binning.TILE_SPAN
    assert int(bins["spans"][0]) > 0
    kw = dict(height_padded=hp, width_padded=wp, tile_h=8, tile_w=128,
              layout="flat")
    args = (bins["pair_tri"], bins["seg_start"], bins["seg_count"])
    smoke = _smoke()
    for mode, tab in (("texf_mip", table), ("base", table[:, :32])):
        rk, kk = port.raster.raster_shade_tiles(
            tab, *args, x["eff"], x["vpos"], x["lwp"], x["lc"], x["li"],
            mode=mode, worklist=(bins["worklist"], bins["k"]),
            spans=bins["spans"], **kw)
        rp, kp = port.raster.raster_shade_tiles_plain(
            tab, *args, params, lights, mode=mode, **kw)
        smoke.compare_outputs(f"cell frame {mode}", mode, rk, kk, rp, kp)
