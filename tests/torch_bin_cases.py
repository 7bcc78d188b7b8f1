"""The cases of the tile path's binning stage, of the rasters' shading
parameters and of the bin sort, made from seeds with numpy:
``tests/test_torch_tile_bins.py`` and ``tests/test_torch_bin_sort.py``
hold the port's twins to the JAX package on them, and ``chip_smoke.py``
the kernels (``csrc/bins.cu``, ``csrc/sort.cu``) to the twins on the
card. Imports neither pytest nor JAX."""

import numpy as np

NTX, NTY = 4, 12  # 1024x192 at 16x256 tiles


def _rect_meta(x0, y0, rx, ry, alive):
    """(4, T) int32 meta [x0, y0, rx, c] with c = rx * ry where alive, 0
    elsewhere (a dead triangle keeps its rect columns, as the front's)."""
    c = np.where(alive, rx * ry, 0)
    return np.stack([x0, y0, rx, c]).astype(np.int32)


def _random_meta(rng, T, ntx, nty, span=3, dead=0.25):
    x0 = rng.integers(0, ntx, T)
    y0 = rng.integers(0, nty, T)
    rx = np.minimum(rng.integers(1, span + 1, T), ntx - x0)
    ry = np.minimum(rng.integers(1, span + 1, T), nty - y0)
    return _rect_meta(x0, y0, rx, ry, rng.random(T) >= dead)


def meta_case(name):
    """(meta (4, T) int32, ntx, nty, tile_cap, (c0, c1) or None): the
    meta of a case, made from a seed; the last entry cuts a chunk view."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name.startswith("random"):
        seed = int(name[-1])
        return (_random_meta(np.random.default_rng(seed), 700, NTX, NTY),
                NTX, NTY, 128, None)
    if name == "grid_edges":
        # Rects that end on the grid's last column and row, and some that
        # lie on them alone, at a ragged grid (5 x 7 tiles).
        ntx, nty, T = 5, 7, 120
        x0 = rng.integers(0, ntx, T)
        y0 = rng.integers(0, nty, T)
        rx, ry = ntx - x0, nty - y0
        x0[::3], rx[::3] = ntx - 1, 1
        y0[1::3], ry[1::3] = nty - 1, 1
        return _rect_meta(x0, y0, rx, ry, rng.random(T) < 0.9), ntx, nty, \
            96, None
    if name == "tile_over_cap":
        # 200 triangles on tile (1, 2) among scattered ones: one tile over
        # C = 128, whose exact count the report carries.
        meta = _random_meta(rng, 500, NTX, NTY, span=1)
        hot = rng.choice(500, 200, replace=False)
        meta[0, hot], meta[1, hot], meta[2, hot], meta[3, hot] = 1, 2, 1, 1
        return meta, NTX, NTY, 128, None
    if name == "none_alive":
        meta = _random_meta(rng, 400, NTX, NTY)
        meta[3] = 0
        return meta, NTX, NTY, 128, None
    if name == "one_triangle":
        return _rect_meta(np.array([1]), np.array([3]), np.array([2]),
                          np.array([4]), np.array([True])), NTX, NTY, 128, \
            None
    if name == "chunk_view":
        return (_random_meta(rng, 900, NTX, NTY), NTX, NTY, 128, (300, 650))
    raise KeyError(name)


META_CASES = ["random0", "random1", "random2", "grid_edges", "tile_over_cap",
              "none_alive", "one_triangle", "chunk_view"]
BIN_KEYS = ("bin_rows", "seg_start", "seg_count", "total_pairs",
            "pair_needed", "tile_needed", "worklist", "k", "overflow")


def shading_case(pkg, effect):
    """(effect, view_position, light pos, color, intensity) as numpy; the
    effects of tests/test_torch_micro.py's parametrisation."""
    E = pkg.effects.Effect
    make = {
        "none": None,
        "voxelize": lambda: E.voxelize(0.5, 1.0),
        "edge_melt": lambda: E.edge_melt(0.2, 1.0),
        "mirage": lambda: E.mirage(0.6, 0.7, 0.3),
    }[effect]
    eff = np.zeros(6, np.float32)
    if make is not None:
        e = make()
        e.update(0.35)
        eff = np.asarray(e.uniform(scene_time=0.35).as_array(), np.float32)
    rng = np.random.default_rng(3)
    return (eff, rng.uniform(-4, 4, 4).astype(np.float32),
            rng.uniform(-5, 5, (3, 3)).astype(np.float32),
            rng.uniform(0, 1, (3, 3)).astype(np.float32),
            rng.uniform(0, 2, 3).astype(np.float32))


# The bin sort's cases: the micro layout at 2 x 3 tiles of 16 cells
# (256x24 px), the flat one on NTX x NTY tiles; LONG pairs in the long
# segment, across several of the kernel's chunks (binning.SORT_CHUNK).
NTX_T, NTY_T = 2, 3
LONG = 5000


def _sort_meta(rng, T, ntx, nty, span=4, dead=0.25):
    """(4, T) int32 meta [x0, y0, rx, c], rects inside the grid, c = rx *
    ry for alive triangles, 0 for dead ones (the front's contract)."""
    x0 = rng.integers(0, ntx, T)
    y0 = rng.integers(0, nty, T)
    rx = np.minimum(rng.integers(1, span + 1, T), ntx - x0)
    ry = np.minimum(rng.integers(1, span + 1, T), nty - y0)
    c = np.where(rng.random(T) >= dead, rx * ry, 0)
    return np.stack([x0, y0, rx, c]).astype(np.int32)


def sort_case(layout, name, long=LONG):
    """(meta, ntx, nty, pair_cap, cap) of a bin sort case
    (tests/test_torch_bin_sort.py, chip_smoke.py): ``ntx`` is the grid's
    bins across (16 cells a tile on the micro layout), ``cap`` the flat
    layout's tile cap (None on the micro layout); the "long" case puts
    ``long`` single-bin triangles on one bin."""
    rng = np.random.default_rng(sum(map(ord, layout + name)))
    ntx, nty = (NTX_T * 16, NTY_T) if layout == "micro" else (NTX, NTY)
    cap = None if layout == "micro" else 8192
    meta = _sort_meta(rng, 700, ntx, nty)
    if name == "long":
        hot = np.zeros((4, long), np.int32)
        hot[0], hot[1], hot[2], hot[3] = ntx // 2, nty // 2, 1, 1
        meta = np.concatenate([meta[:, :300], hot, meta[:, 300:]], axis=1)
    elif name == "empty":
        meta[3] = 0
    total = int(meta[3].sum())
    pair_cap = total + 64
    if name == "pair_overflow":
        pair_cap = total // 2
    elif name == "tile_overflow":
        cap = 24
    return meta, ntx, nty, pair_cap, cap


SORT_CASES = ["random", "long", "empty", "pair_overflow", "tile_overflow"]
MICRO_SORT_CASES = ["random", "long", "empty", "pair_overflow"]


def sort_pairs(meta, ntx, num_bins, pair_cap):
    """The pair list in triangle order, numpy: each alive triangle's rect
    walked row by row (bin = cy * ntx + cx, which on the micro layout is
    the cell id), the num_bins sentinel and triangle 0 past the total."""
    x0, y0, rx, c = (meta[i].astype(np.int64) for i in range(4))
    tri = np.repeat(np.arange(c.shape[0]), c)
    start = np.cumsum(c) - c
    local = np.arange(tri.shape[0]) - start[tri]
    w = np.maximum(rx[tri], 1)
    key = (y0[tri] + local // w) * ntx + x0[tri] + local % w
    keys = np.full(pair_cap, num_bins, np.int32)
    tris = np.zeros(pair_cap, np.int32)
    n = min(tri.shape[0], pair_cap)
    keys[:n], tris[:n] = key[:n], tri[:n]
    return keys, tris, int(c.sum())


# Flat tile layouts whose lists the tile raster cuts into spans: a block
# of triangles over tiles (0..1, 0..2), more over tile (3, 5) alone, among
# scattered ones; (meta, ntx, nty, pair_cap, tile_cap). "long_capped"
# clamps the longest lists at the tile cap, "long_pair_overflow" cuts the
# pair list inside them.
SPAN_CASES = ["long", "long_capped", "long_pair_overflow"]


def span_case(name):
    rng = np.random.default_rng(sum(map(ord, name)))
    meta = _random_meta(rng, 3000, NTX, NTY)
    block = rng.choice(3000, 1900, replace=False)
    meta[0, block[:1100]], meta[1, block[:1100]] = 0, 0
    meta[2, block[:1100]], meta[3, block[:1100]] = 2, 6
    meta[0, block[1100:]], meta[1, block[1100:]] = 3, 5
    meta[2, block[1100:]], meta[3, block[1100:]] = 1, 1
    pair_cap = 2500 if name == "long_pair_overflow" else 16384
    tile_cap = 700 if name == "long_capped" else 4096
    return meta, NTX, NTY, pair_cap, tile_cap
