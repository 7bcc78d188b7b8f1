"""Triangle-to-tile and triangle-to-cell binning, in torch ops.

Counterpart of the JAX package's ``backends/binning.py`` (the tile half,
:43-316 and 592-608, and the micro path's cell half, :324-589)
and the replacement for the reference's four binning kernels
(binning.wgsl: count, two-pass scan, store). A stable sort by tile id (or a
rank search over the coverage matrix) gives every tile its triangles in
ascending index order — deterministic, where the reference's atomic slot
claim is not — and overflow is *reported*, with the capacity a retry needs,
instead of written out of bounds (gpu_buffers.rs:53-63).

Two layouts, the same contract:

- dense (``bin_triangles_dense``): a (num_tiles, C) row of triangle ids
  per tile;
- flat (``bin_triangles_sort``): the tile-sorted pair list plus per-tile
  (start, count).

On the tile path ``bin_tiles_meta`` bins straight from the front end's
meta and adds what the raster and the retry read besides: the
occupied-tile work list and the (2,) overflow report. On a CUDA tensor
its dense layout is the hand-written kernel ``csrc/bins.cu``
(``bin_tiles_dense``), its flat layout the pair expansion
(``csrc/expand.cu``, row-major tile ids) and the bin sort
(``csrc/sort.cu``); a CPU tensor takes the twin, ``bin_tiles_meta_plain``.

The micro path bins at 8x8 cells instead (``bin_cells_sort_meta``): the
pair expansion, then the same bin sort, 16 cells a tile.

``bin_sort`` is the stable sort of a pair list by bin, with its segments,
work list and overflow report: the kernel ``csrc/sort.cu`` on a CUDA
tensor, its twin ``bin_sort_plain`` (one stable ``torch.sort`` and
searchsorted segments) on a CPU tensor.

Each binning entry takes an optional ``acc``, a (8,) int64 tensor that a
batch of frames shares: [pair need, tile need, pairs, occupied tiles,
samples, textured pixels, spans, longest list] — the needs, the words
summed over the frames, then the one folded by max. The step that ends
the binning folds its frame (or triangle chunk) into the first four, the
seventh and the last: the needs by max, the pairs (``total_pairs``), the
occupied tiles (``k``) and, in the flat tile layout, the tile raster's
span blocks beyond each tile's first (the entries of ``spans``; 0 in the
dense and micro layouts) by sum, and the longest list (``most``, the
largest bin count before any cap: the triangles of the tile the tile
raster's last block walks, or a micro cell's pairs) by max. On the card
the kernel that writes the overflow report does it (64-bit atomics); the
twins fold with torch ops (``fold_counts``). The fifth word is the micro
raster's: the coverage samples it tested (``micro.raster_shade_micro``);
the sixth the mip texture tail's: the pixels it shaded from an image
(``texture.texture_tail_mip``).

The flat tile layout also writes ``spans``, the tile raster's span list:
a tile whose (clamped) list holds more than ``TILE_SPAN`` triangles is
walked in spans of ``TILE_SPAN`` list positions, a block each, merged
exactly (``csrc/raster.cu``). The (1 + 2 ``span_slots``,) int32 list is
[count, then count (tile, k) pairs by tile and k], one for each span k >=
1 of such a tile, zeros past them (``span_list_plain``); at most
``span_slots`` fit, since they sum to at most the listed pairs over
``TILE_SPAN``. The bin sort's scan scans them as it scans the pairs.

Every integer output equals the JAX package's bit for bit. The TPU-only
padding of the outputs (8-row blocks, 1024-element DMA windows) is not
carried: the raster kernel here reads exactly ``seg_count`` entries.
Nothing here synchronises with the host: overflow reports stay tensors.
"""

from __future__ import annotations

import torch

from compute_renderer_torch import tracing

I32 = torch.int32

# Above this many rank-search ops (num_tiles * tile_cap * T) the dense
# layout gives way to the sort. Kept equal to the JAX package's value so
# both packages pick the same layout; the cost balance on the GPU is not
# measured yet.
DENSE_BINNING_OP_LIMIT = 600_000_000

# The bin sort kernel (csrc/sort.cu): the pair slots are sorted stably by
# bin in chunks of SORT_CHUNK, one block of SORT_WARPS warps each, and
# counted in table chunks of 1, 2 or 4 chunks (``sort_table_chunk``: the
# fewest that keep the (table chunk, bin) table within SORT_TABLE_CELLS);
# the scan takes SORT_SCAN_TILE bins a block.
SORT_CHUNK = 2048
SORT_MAX_FACTOR = 4
SORT_TABLE_CELLS = 1 << 21
SORT_WARPS = 8
SORT_SCAN_TILE = 128
# No per-bin cap (the micro layout's ``cap``).
CAP_NONE = 2**31 - 1
# The list positions a tile raster block walks where a tile's list is cut
# into spans (csrc/tile_span.cuh's TILE_SPAN; one round of the raster's
# CHUNK). The kernels are built with it; the twins read it when called.
TILE_SPAN = 256


def cover_counts(setup):
    """Per-triangle covered-rect dims and cover-pair counts: (rx, ry, c)
    with c = rx*ry for alive triangles, 0 otherwise."""
    rx = (setup["tile_x1"] - setup["tile_x0"]).to(I32)
    ry = (setup["tile_y1"] - setup["tile_y0"]).to(I32)
    return rx, ry, torch.where(setup["alive"], rx * ry, 0).to(I32)


def setup_from_meta(meta):
    """The binning's ``triangle_setup`` dict from the front end's meta rows
    (4, T) = [tile_x0, tile_y0, rx, c]. Exact for alive triangles (c =
    rx*ry with rx >= 1); dead ones (c == 0) get an empty rect, which every
    consumer masks by ``alive`` anyway."""
    x0 = meta[0].to(I32)
    y0 = meta[1].to(I32)
    rx = meta[2].to(I32)
    c = meta[3].to(I32)
    alive = c > 0
    ry = torch.div(c, torch.clamp(rx, min=1), rounding_mode="floor")
    return {
        "tile_x0": x0,
        "tile_y0": y0,
        "tile_x1": x0 + torch.where(alive, rx, 0).to(I32),
        "tile_y1": y0 + torch.where(alive, ry, 0).to(I32),
        "alive": alive,
    }


def dense_layout(ntx: int, nty: int, tile_cap: int, T: int) -> bool:
    """Whether ``T`` triangles bin in the dense layout: the rank search's
    op count against ``DENSE_BINNING_OP_LIMIT`` (the JAX package's rule,
    so both packages pick the same layout)."""
    return ntx * nty * tile_cap * max(T, 1) <= DENSE_BINNING_OP_LIMIT


def bin_triangles(setup, ntx: int, nty: int, pair_cap: int, tile_cap: int):
    """Dispatch to the dense or sort layout by ``dense_layout``."""
    if dense_layout(ntx, nty, tile_cap, setup["alive"].shape[0]):
        return bin_triangles_dense(setup, ntx, nty, pair_cap, tile_cap)
    return bin_triangles_sort(setup, ntx, nty, pair_cap, tile_cap)


def bin_triangles_dense(setup, ntx: int, nty: int, pair_cap: int,
                        tile_cap: int):
    """Dense-rank binning: coverage matrix cov (num_tiles, T), per-tile
    counts by reduction, and the s-th triangle of tile j as the first t
    with R[j, t] >= s+1, where R = cumsum(cov) along t. The JAX package
    evaluates that search as a (num_tiles, C, T) compare-and-count; here
    ``torch.searchsorted`` on the non-decreasing rows of R gives the same
    integers without the third axis (805 M elements at 16k triangles).

    ``tile_cap`` is rounded up to a multiple of 128, as in the JAX package,
    so the capacities and the overflow report agree between the two."""
    num_tiles = ntx * nty
    T = setup["alive"].shape[0]
    device = setup["alive"].device
    tile_cap = (tile_cap + 127) // 128 * 128

    tile_ids = torch.arange(num_tiles, dtype=I32, device=device)
    jx = (tile_ids % ntx)[:, None]
    jy = torch.div(tile_ids, ntx, rounding_mode="floor")[:, None]
    cov = (setup["alive"][None, :]
           & (jx >= setup["tile_x0"][None, :]) & (jx < setup["tile_x1"][None, :])
           & (jy >= setup["tile_y0"][None, :]) & (jy < setup["tile_y1"][None, :]))

    counts = cov.sum(dim=1, dtype=I32)
    seg_start = torch.cumsum(counts, 0, dtype=I32) - counts

    R = torch.cumsum(cov, 1, dtype=I32)  # (num_tiles, T), rows non-decreasing
    s_plus_1 = torch.arange(1, tile_cap + 1, dtype=I32, device=device)
    tri_of_slot = torch.searchsorted(
        R, s_plus_1.expand(num_tiles, tile_cap).contiguous(), side="left",
        out_int32=True,
    )
    tri_of_slot = torch.clamp(tri_of_slot, max=max(T - 1, 0))

    max_count = counts.max() if num_tiles > 0 else torch.zeros(
        (), dtype=I32, device=device)
    tile_overflow = max_count > tile_cap
    return {
        "bin_rows": tri_of_slot,
        "seg_start": seg_start,
        "seg_count": torch.clamp(counts, max=tile_cap),
        "total_pairs": counts.sum(dtype=I32),
        "pair_needed": torch.zeros((), dtype=I32, device=device),
        "tile_needed": torch.where(tile_overflow, max_count, 0).to(I32),
        "most": max_count.to(I32),
        "layout": "dense",
    }


def expand_pair_owners(starts, counts, pair_cap: int):
    """tri_of_pair: the triangle owning each pair slot p (the rightmost t
    with starts[t] <= p among triangles with counts > 0). Triangles with
    counts > 0 have strictly increasing starts, so scattering t at
    starts[t] and taking a running max reconstructs the ownership; slots
    past the last seed inherit the last live triangle (masked invalid
    downstream)."""
    T = starts.shape[0]
    device = starts.device
    tpos = torch.where((counts > 0) & (starts < pair_cap), starts, pair_cap)
    seed = torch.zeros((pair_cap + 1,), dtype=I32, device=device)
    seed.scatter_(0, tpos.long(), torch.arange(T, dtype=I32, device=device))
    return torch.cummax(seed[:pair_cap], 0).values


def exact_tile_counts(setup, ntx: int, nty: int):
    """Exact per-tile cover counts without the pair list: +1/-1 at each
    rect's corners of an (nty+1, ntx+1) grid, then a 2-D prefix sum.
    Independent of pair_cap, so it stays exact when the pair list
    overflows."""
    x0 = setup["tile_x0"].long()
    x1 = setup["tile_x1"].long()
    y0 = setup["tile_y0"].long()
    y1 = setup["tile_y1"].long()
    w = setup["alive"].to(I32)
    # Out-of-range corners are dropped, as the JAX scatter's mode="drop"
    # drops them: route them to a spill slot past the grid.
    size = (nty + 1) * (ntx + 1)
    grid = torch.zeros((size + 1,), dtype=I32, device=w.device)

    def add(ys, xs, val):
        ok = (ys >= 0) & (ys <= nty) & (xs >= 0) & (xs <= ntx)
        grid.index_add_(0, torch.where(ok, ys * (ntx + 1) + xs, size), val)

    add(y0, x0, w)
    add(y0, x1, -w)
    add(y1, x0, -w)
    add(y1, x1, w)
    g = grid[:size].reshape(nty + 1, ntx + 1)
    counts = torch.cumsum(torch.cumsum(g, 0, dtype=I32), 1, dtype=I32)
    return counts[:nty, :ntx].reshape(-1)


def bin_triangles_sort(setup, ntx: int, nty: int, pair_cap: int,
                       tile_cap: int):
    """Sorted (tile, triangle) pair list + per-tile segments.

    Returns a dict: ``pair_tri`` (pair_cap,) triangle ids sorted by tile,
    ``seg_start`` / ``seg_count`` (num_tiles,) (count clamped to
    tile_cap), ``total_pairs``, the needed capacities ``pair_needed``
    / ``tile_needed`` (0 = within capacity), ``most``, the largest
    tile count, unclamped, exact even when the pair list overflows, and
    ``spans``, the tile raster's span list (the module docstring)."""
    num_tiles = ntx * nty
    device = setup["alive"].device
    rx, _, c = cover_counts(setup)

    starts = torch.cumsum(c, 0, dtype=I32) - c
    total = (starts[-1] + c[-1]) if c.shape[0] > 0 else torch.zeros(
        (), dtype=I32, device=device)

    p = torch.arange(pair_cap, dtype=I32, device=device)
    tri_of_pair = expand_pair_owners(starts, c, pair_cap)
    valid = p < total

    owner = tri_of_pair.long()
    local = p - starts[owner]
    trx = torch.clamp(rx[owner], min=1)
    tile_of_pair = (
        (setup["tile_y0"][owner] + torch.div(local, trx, rounding_mode="floor"))
        * ntx
        + (setup["tile_x0"][owner] + torch.remainder(local, trx))
    ).to(I32)
    tile_of_pair = torch.where(valid, tile_of_pair, num_tiles).to(I32)

    # Stable: pairs are generated in triangle order, so each tile keeps
    # ascending triangle ids. Counts from the pair_cap-bounded list
    # under-report when it overflows; then the exact corner-scatter counts
    # decide the tile need.
    exact = exact_tile_counts(setup, ntx, nty) if num_tiles > 0 else None
    bins = bin_sort_plain(tile_of_pair, tri_of_pair, total, num_tiles,
                          cap=tile_cap, exact=exact, spans=True)
    out = {k: bins[k] for k in ("pair_tri", "seg_start", "seg_count",
                                "total_pairs", "pair_needed", "tile_needed",
                                "most", "spans")}
    out["layout"] = "flat"
    return out


def occupied_worklist(seg_count):
    """(ascending occupied-tile ids padded with 0, occupied count) — a
    cumsum and a scatter, with no host synchronisation. The rasters launch
    over it (``raster.py``, ``micro.py``)."""
    num_tiles = seg_count.shape[0]
    device = seg_count.device
    occ = seg_count > 0
    incl = torch.cumsum(occ, 0, dtype=I32)
    k = incl[-1] if num_tiles > 0 else torch.zeros((), dtype=I32,
                                                   device=device)
    pos = torch.where(occ, incl - 1, num_tiles).long()
    wl = torch.zeros((num_tiles + 1,), dtype=I32, device=device)
    wl.scatter_(0, pos, torch.arange(num_tiles, dtype=I32, device=device))
    return wl[:num_tiles], k


# [pair need, tile need, pairs, occupied tiles, samples, textured pixels,
#  spans, longest list]
ACC_WORDS = 8


def fold_counts(acc, bins):
    """Fold ``bins``' overflow report, ``total_pairs`` and ``k`` into
    ``acc``'s first four words, its span list's entries (where it has one)
    into the seventh and its ``most`` into the last (see the module
    docstring) with torch ops: the twins' fold; a None ``acc`` folds
    nothing."""
    if acc is None:
        return
    i64 = torch.int64
    needs = acc[:2]
    torch.maximum(needs, bins["overflow"].to(i64), out=needs)
    acc[2:4].add_(torch.stack([bins["total_pairs"], bins["k"]]).to(i64))
    if "spans" in bins:
        acc[6:7].add_(bins["spans"][:1].to(i64))
    longest = acc[7:]
    torch.maximum(longest, bins["most"].to(i64).reshape(1), out=longest)


def span_slots(pair_cap: int) -> int:
    """Entries the flat layout's span list holds: ceil(pair_cap /
    ``TILE_SPAN``), at least 1."""
    return max(-(-pair_cap // TILE_SPAN), 1)


def span_list_plain(seg_count, pair_cap: int):
    """The flat layout's span list in torch (the module docstring): for
    each tile whose ``seg_count`` (clamped) exceeds ``TILE_SPAN``, (tile,
    k) for k = 1 .. (count - 1) // ``TILE_SPAN``, by tile and k, after
    their count; zeros past them. (1 + 2 ``span_slots``,) int32."""
    device = seg_count.device
    span = TILE_SPAN
    counts = seg_count.long()
    extra = torch.where(counts > span, torch.div(counts - 1, span,
                                                 rounding_mode="floor"), 0)
    tiles = torch.repeat_interleave(
        torch.arange(counts.shape[0], device=device), extra)
    first = torch.cumsum(extra, 0) - extra
    k = torch.arange(tiles.shape[0], device=device) - first[tiles] + 1
    out = torch.zeros((1 + 2 * span_slots(pair_cap),), dtype=I32,
                      device=device)
    out[0] = tiles.shape[0]
    out[1:1 + 2 * tiles.shape[0]] = torch.stack([tiles, k], 1).reshape(-1)
    return out


def acc_pointer(acc, device):
    """``acc``'s device pointer for a kernel (None, a null pointer, when
    ``acc`` is None), its dtype, shape and device checked."""
    if acc is None:
        return None
    if (acc.dtype != torch.int64 or tuple(acc.shape) != (ACC_WORDS,)
            or acc.device != device or not acc.is_contiguous()):
        raise ValueError(f"acc: {acc.dtype} {tuple(acc.shape)} on "
                         f"{acc.device}; expected ({ACC_WORDS},) int64 on "
                         f"{device}")
    return acc.data_ptr()


def _with_worklist(bins):
    """``bins`` with the occupied-tile work list (``worklist``, ``k``) and
    the (2,) overflow report [pair_needed, tile_needed]."""
    bins["worklist"], bins["k"] = occupied_worklist(bins["seg_count"])
    bins["overflow"] = torch.stack([bins["pair_needed"], bins["tile_needed"]])
    return bins


# ---------------------------------------------------------------------------
# The bin sort: a pair list in (bin, triangle) order, both layouts
# ---------------------------------------------------------------------------

def _bin_extras(counts, seg_start, total, pair_cap: int, group: int,
                cap: int, exact, spans: bool = False):
    """What the bin sort adds to the segments: the clamped counts, the
    group's tile counts and window bases (group 16), the occupied-tile
    work list, the total, the needed capacities, the overflow report and,
    with ``spans``, the span list (``span_list_plain``)."""
    device = counts.device
    num_bins = counts.shape[0]
    total = total.to(I32)
    over = total > pair_cap
    if num_bins == 0:
        most = torch.zeros((), dtype=I32, device=device)
    elif exact is not None:
        most = torch.where(over, exact.max(), counts.max())
    else:
        most = counts.max()
    out = {"seg_start": seg_start, "seg_count": torch.clamp(counts, max=cap),
           "total_pairs": total,
           "pair_needed": torch.where(over, total, 0).to(I32),
           "tile_needed": torch.where(most > cap, most, 0).to(I32),
           "most": most.to(I32)}
    occupied = out["seg_count"]
    if group == 16:
        out["tile_count"], out["win_start"] = _cell_tiles(
            counts, seg_start, num_bins // 16)
        occupied = torch.clamp(out["tile_count"], max=cap)
    out["worklist"], out["k"] = occupied_worklist(occupied)
    out["overflow"] = torch.stack([out["pair_needed"], out["tile_needed"]])
    if spans:
        out["spans"] = span_list_plain(out["seg_count"], pair_cap)
    return out


def bin_sort_plain(keys, tris, total, num_bins: int, *, group: int = 1,
                   cap: int = CAP_NONE, exact=None, acc=None,
                   spans: bool = False):
    """The twin of ``bin_sort``: one stable ``torch.sort`` of the keys
    carrying the triangles, then searchsorted segments
    (``segments_from_sorted_cells`` at 16 cells a tile) and
    ``_bin_extras``; ``exact`` is the (num_bins,) exact counts the tile
    need takes under pair overflow (the flat layout's), or None; with
    ``spans`` the span list too. Folds into ``acc`` (``fold_counts``)."""
    sorted_bin, order = torch.sort(keys, stable=True)
    if group == 16:
        seg_start, counts, _, _ = segments_from_sorted_cells(
            sorted_bin, num_bins, num_bins // 16)
    else:
        ids = torch.arange(num_bins, dtype=I32, device=keys.device)
        seg_start = torch.searchsorted(sorted_bin, ids, side="left",
                                       out_int32=True)
        counts = torch.searchsorted(sorted_bin, ids, side="right",
                                    out_int32=True) - seg_start
    out = _bin_extras(counts, seg_start, total, keys.shape[0], group, cap,
                      exact, spans)
    out["pair_tri"] = tris[order]
    fold_counts(acc, out)
    return out


def sort_chunk_plain(keys, vals, span: int, warps: int = SORT_WARPS):
    """csrc/sort.cu's ``sort_chunk`` in torch (tests only, CPU): a chunk's
    slots sorted stably by key, the keys rebased to the chunk's lowest
    bin, a key outside [0, span) becoming span. Least-significant-digit
    passes of D <= 8 bits over the bits of span; in each, the chunk's
    slots are ``warps`` contiguous groups, and a slot goes to the
    exclusive scan of the (digit, group) counts in (digit, group) order
    plus its rank among its group's earlier slots of its digit. Returns
    (keys, vals)."""
    L = keys.shape[0]
    k = torch.where((keys >= 0) & (keys < span), keys, span).long()
    v = vals.clone()
    bits = span.bit_length()
    passes = -(-bits // 8)
    width = -(-bits // passes) if passes else 0
    group = torch.arange(L) * warps // max(L, 1)
    for s in range(passes):
        cell = ((k >> (s * width)) & ((1 << width) - 1)) * warps + group
        # The rank among the group's earlier slots of the digit: the
        # slot's place in slot order within its (digit, group) cell.
        by_cell = torch.argsort(cell * L + torch.arange(L))
        counts = torch.bincount(cell, minlength=warps << width)
        base = torch.cumsum(counts, 0) - counts
        rank = torch.empty((L,), dtype=torch.long)
        rank[by_cell] = torch.arange(L) - base[cell[by_cell]]
        dest = base[cell] + rank
        k2, v2 = torch.empty_like(k), torch.empty_like(v)
        k2[dest], v2[dest] = k, v
        k, v = k2, v2
    return k, v


def run_ranks_plain(sorted_keys):
    """Each slot's place in its run of equal keys of a sorted list: the
    slot less the first slot of its run (csrc/sort.cu ``place_chunk``)."""
    L = sorted_keys.shape[0]
    q = torch.arange(L)
    start = torch.ones((L,), dtype=torch.bool)
    start[1:] = sorted_keys[1:] != sorted_keys[:-1]
    first = torch.cummax(torch.where(start, q, 0), 0).values
    return q - first


def bin_sort_steps_plain(keys, tris, total, num_bins: int, *,
                         group: int = 1, cap: int = CAP_NONE, exact=None,
                         chunk: int = SORT_CHUNK, wide: int = 0,
                         spans: bool = False):
    """The kernel's decomposition of ``bin_sort_plain`` in torch (tests
    only, CPU): the valid slots cut into table chunks of ``wide`` slots, a
    multiple of ``chunk`` (0: ``sort_table_chunk``'s); each table chunk's count
    of each bin (a (table chunk, bin) table); the table scanned in (bin,
    table chunk) order, which gives each bin's segment start and its base
    in each table chunk; then each chunk of ``chunk`` slots sorted by bin
    as the kernel sorts it (``sort_chunk_plain`` on the keys less the
    chunk's lowest bin, the slots past the list holding the sentinel) and
    each pair placed at its bin's base in the table chunk, plus the bin's
    pairs in the table chunk's slots ahead of the chunk, plus its rank
    among the chunk's pairs of that bin. Equal to ``bin_sort_plain`` on
    the valid prefix of ``pair_tri`` and on every other output."""
    pair_cap = keys.shape[0]
    n = max(min(int(total), pair_cap), 0)
    wide = wide or sort_table_chunk(pair_cap, num_bins)
    nt = -(-n // wide)
    k = keys[:n].long()
    ok = (k >= 0) & (k < num_bins)
    table = torch.zeros((nt, num_bins), dtype=torch.long)
    table.index_put_((torch.arange(n)[ok] // wide, k[ok]),
                     torch.ones((int(ok.sum()),), dtype=torch.long),
                     accumulate=True)
    flat = table.t().reshape(-1)  # (bin, table chunk) order
    base = (torch.cumsum(flat, 0) - flat).reshape(num_bins, nt).t()
    counts = table.sum(0)
    pair_tri = torch.zeros((pair_cap,), dtype=I32)
    warps = min(SORT_WARPS, chunk)
    for c0 in range(0, n, chunk):
        c1 = min(c0 + chunk, n)
        live = k[c0:c1][ok[c0:c1]]
        if live.numel() == 0:
            continue
        lo, span = int(live.min()), int(live.max() - live.min()) + 1
        fill = chunk - (c1 - c0)
        sk, sv = sort_chunk_plain(
            torch.cat([keys[c0:c1].long() - lo,
                       torch.full((fill,), -1, dtype=torch.long)]),
            torch.cat([tris[c0:c1], torch.zeros((fill,), dtype=tris.dtype)]),
            span, warps)
        t0 = c0 // wide * wide
        ahead = k[t0:c0][ok[t0:c0]]
        at = sk < span
        b = sk[at] + lo
        pos = (base[c0 // wide][b] + (ahead[:, None] == b[None, :]).sum(0)
               + run_ranks_plain(sk)[at])
        pair_tri[pos] = sv[at].to(I32)
    seg_start = (torch.cumsum(counts, 0) - counts).to(I32)
    out = _bin_extras(counts.to(I32), seg_start, total, pair_cap, group,
                      cap, exact, spans)
    out["pair_tri"] = pair_tri
    return out


def sort_table_chunk(pair_cap: int, num_bins: int) -> int:
    """The bin sort kernel's table chunk, in slots: ``SORT_CHUNK`` times
    the least factor of 1, 2 or 4 whose (table chunk, bin) table holds at
    most ``SORT_TABLE_CELLS`` cells (csrc/sort.cu's ``bin_sort``)."""
    wide = SORT_CHUNK
    while (wide < SORT_CHUNK * SORT_MAX_FACTOR
           and max(-(-pair_cap // wide), 1) * num_bins > SORT_TABLE_CELLS):
        wide *= 2
    return wide


def sort_scratch_ints(pair_cap: int, num_bins: int, rects: bool,
                      spans: bool = False) -> int:
    """The bin sort kernel's scratch, in int32 words (csrc/sort.cu's
    ``bin_sort``): four a scan tile of ``SORT_SCAN_TILE`` bins (its
    look-back words; six with ``spans``), the exact counts with the
    rects, the span list with ``spans`` (``span_offset``), then each
    table chunk's range of bins and the (table chunk, bin) table."""
    chunks = max(-(-pair_cap // sort_table_chunk(pair_cap, num_bins)), 1)
    return (span_offset(num_bins, rects, spans)
            + (1 + 2 * span_slots(pair_cap) if spans else 0)
            + 2 * chunks + chunks * num_bins)


def span_offset(num_bins: int, rects: bool, spans: bool) -> int:
    """Where the bin sort's scratch holds the span list, in int32 words:
    past the look-back words and the exact counts."""
    tiles = max(-(-num_bins // SORT_SCAN_TILE), 1)
    return (6 if spans else 4) * tiles + (num_bins if rects else 0)


def _bin_sort_cuda(keys, tris, total, num_bins, group, cap, meta, ntx,
                   acc=None, spans=False):
    from compute_renderer_torch import _build

    device = keys.device
    pair_cap = keys.shape[0]
    keys = keys.to(I32).contiguous()
    tris = tris.to(I32).contiguous()
    total = total.to(I32).reshape(())
    if total.device != device or tris.shape != (pair_cap,):
        raise ValueError(f"bin_sort: tris {tuple(tris.shape)} on "
                         f"{tris.device}, total on {total.device}, keys "
                         f"({pair_cap},) on {device}")
    rows = [None] * 4
    T = 0
    if meta is not None:
        T = meta.shape[1]
        if meta.dtype != I32 or (T > 1 and meta.stride(1) != 1):
            meta = meta.to(I32).contiguous()
        rows = [meta[3], meta[2], meta[0], meta[1]]  # c, rx, x0, y0
    num_tiles = num_bins // group
    scratch = torch.empty(
        (sort_scratch_ints(pair_cap, num_bins, meta is not None, spans),),
        dtype=I32, device=device)
    seg = torch.empty((2, num_bins), dtype=I32, device=device)
    pair_tri = torch.empty((pair_cap,), dtype=I32, device=device)
    worklist = torch.empty((num_tiles,), dtype=I32, device=device)
    tile_count = win_start = None
    if group == 16:
        tile_count, win_start = torch.empty((2, num_tiles), dtype=I32,
                                            device=device)
    scal = torch.empty((5,), dtype=I32, device=device)
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    fn = _build.entry("sort", "bin_sort", pointers=16, ints=7)
    tracing.launch("bin_sort")
    _build.check(
        fn(keys.data_ptr(), tris.data_ptr(), total.data_ptr(),
           *(ptr(r) for r in rows), scratch.data_ptr(), pair_tri.data_ptr(),
           seg[0].data_ptr(), seg[1].data_ptr(), ptr(tile_count),
           ptr(win_start), worklist.data_ptr(), scal.data_ptr(),
           acc_pointer(acc, device), T, pair_cap, num_bins, group, int(cap),
           ntx, int(spans), torch.cuda.current_stream(device).cuda_stream),
        "bin_sort",
    )
    out = {"pair_tri": pair_tri, "seg_start": seg[0], "seg_count": seg[1],
           "total_pairs": scal[2], "pair_needed": scal[0],
           "tile_needed": scal[1], "most": scal[4], "worklist": worklist,
           "k": scal[3], "overflow": scal[0:2]}
    if group == 16:
        out["tile_count"], out["win_start"] = tile_count, win_start
    if spans:  # the scan writes it in the cleared part of the scratch
        base = span_offset(num_bins, meta is not None, spans)
        out["spans"] = scratch[base:base + 1 + 2 * span_slots(pair_cap)]
    return out


def bin_sort(keys, tris, total, num_bins: int, *, group: int = 1,
             cap: int = CAP_NONE, meta=None, ntx: int = 0, acc=None,
             spans: bool = False):
    """Stable sort of a pair list by bin, with its segments and work list.

    ``keys`` / ``tris`` (pair_cap,) i32: each pair slot's bin and
    triangle, the first n = min(total, pair_cap) valid and in triangle
    order, the rest holding the ``num_bins`` sentinel (``expand.py``'s
    contract); ``total`` () the pairs in all. ``group`` bins make a tile
    of the work list (16 cells on the micro path, 1 on the flat layout);
    ``cap`` clamps ``seg_count`` and sets the tile need; ``meta`` (4, T)
    [x0, y0, rx, c] with ``ntx`` gives the flat layout's rects, whose
    exact per-tile counts decide the tile need under pair overflow.

    Returns a dict: ``pair_tri`` (pair_cap,) (in (bin, triangle) order on
    [0, n); the rest unspecified), ``seg_start`` / ``seg_count``
    (num_bins,), ``total_pairs``, ``pair_needed``, ``tile_needed``,
    ``most`` (the largest bin count before ``cap``, the rects' exact one
    under pair overflow), ``worklist`` (num_bins / group,) and ``k``,
    ``overflow`` (2,), at group 16 ``tile_count`` and ``win_start``, and
    with ``spans`` (group 1: the flat tile layout) ``spans``, the tile
    raster's span list (the module docstring). Folds into ``acc``
    (the module docstring), None for none.

    CPU tensors take the twin, ``bin_sort_plain``; CUDA tensors the kernel
    ``csrc/sort.cu`` (``launches.bin_sort`` of ``tracing.counters()``
    counts its calls, three launches each; a CUDA graph's capture ticks
    it, its replays do not)."""
    if group not in (1, 16) or num_bins % group or (spans and group != 1):
        raise ValueError(f"bin_sort: {num_bins} bins in groups of {group}"
                         f", spans {spans}")
    if keys.device.type == "cpu":
        exact = None
        if meta is not None and num_bins > 0:
            exact = exact_tile_counts(setup_from_meta(meta), ntx,
                                      num_bins // ntx)
        return bin_sort_plain(keys, tris, total, num_bins, group=group,
                              cap=cap, exact=exact, acc=acc, spans=spans)
    if keys.device.type != "cuda":
        raise ValueError(f"bin_sort: no kernel for device {keys.device}")
    return _bin_sort_cuda(keys, tris, total, num_bins, group, cap, meta, ntx,
                          acc, spans)



def bin_tiles_meta_plain(meta, ntx: int, nty: int, pair_cap: int,
                         tile_cap: int, acc=None):
    """The twin of ``bin_tiles_meta``: ``bin_triangles`` on
    ``setup_from_meta``, then ``occupied_worklist``, folded into ``acc``
    (``fold_counts``)."""
    bins = _with_worklist(bin_triangles(setup_from_meta(meta), ntx, nty,
                                        pair_cap, tile_cap))
    fold_counts(acc, bins)
    return bins


def _bin_tiles_cuda(meta, ntx: int, nty: int, tile_cap: int, acc=None):
    from compute_renderer_torch import _build

    device = meta.device
    T = meta.shape[1]
    if meta.dtype != I32 or (T > 1 and meta.stride(1) != 1):
        meta = meta.to(I32).contiguous()
    num_tiles = ntx * nty
    C = (tile_cap + 127) // 128 * 128
    counts = torch.empty((num_tiles,), dtype=I32, device=device)
    bin_rows = torch.empty((num_tiles, C), dtype=I32, device=device)
    seg = torch.empty((3, num_tiles), dtype=I32, device=device)
    scal = torch.empty((5,), dtype=I32, device=device)
    fn = _build.entry("bins", "bin_tiles_dense", pointers=8, ints=5)
    tracing.launch("bin_tiles_meta")
    _build.check(
        fn(meta.data_ptr(), counts.data_ptr(), bin_rows.data_ptr(),
           seg[0].data_ptr(), seg[1].data_ptr(), seg[2].data_ptr(),
           scal.data_ptr(), acc_pointer(acc, device), meta.stride(0), T,
           ntx, num_tiles, C,
           torch.cuda.current_stream(device).cuda_stream),
        "bin_tiles_dense",
    )
    return {
        "bin_rows": bin_rows,
        "seg_start": seg[0],
        "seg_count": seg[1],
        "total_pairs": scal[2],
        "pair_needed": scal[0],
        "tile_needed": scal[1],
        "most": scal[4],
        "layout": "dense",
        "worklist": seg[2],
        "k": scal[3],
        "overflow": scal[0:2],
    }


def _bin_tiles_flat_cuda(meta, ntx: int, nty: int, pair_cap: int,
                         tile_cap: int, acc=None):
    """The flat layout on the card: the pair expansion with row-major tile
    ids (``csrc/expand.cu``), then ``bin_sort`` with the rects' exact
    counts."""
    from compute_renderer_torch.backends import expand

    num_tiles = ntx * nty
    keys, tris, total = expand._expand_cuda(
        meta[3], meta[2], meta[0], meta[1], pair_cap=pair_cap, ntx_t=0,
        num_cells=num_tiles, row_width=ntx)
    bins = bin_sort(keys, tris, total, num_tiles, cap=tile_cap, meta=meta,
                    ntx=ntx, acc=acc, spans=True)
    bins["layout"] = "flat"
    return bins


def bin_tiles_meta(meta, ntx: int, nty: int, pair_cap: int, tile_cap: int,
                   acc=None):
    """Tile binning from the front end's meta rows (4, T) = [tile_x0,
    tile_y0, rx, c], which may be a chunk ``meta[:, c0:c1]`` of a frame's
    (read in place; triangle ids are chunk-local). Returns
    ``bin_triangles``'s dict plus ``worklist`` (num_tiles,) and ``k`` ()
    (``occupied_worklist`` of ``seg_count``) and ``overflow`` (2,)
    = [pair_needed, tile_needed], folded into ``acc`` (the module
    docstring); the flat layout's also holds ``spans``.

    CPU tensors take the twin. CUDA tensors take the kernel
    ``csrc/bins.cu`` when ``dense_layout`` picks the dense layout
    (``launches.bin_tiles_meta`` counts its calls, two launches each; a
    CUDA graph's capture ticks it, its replays do not), else the pair
    expansion and the bin sort (``_bin_tiles_flat_cuda``; their own
    counters tick). The card's flat layout takes the front's meta
    contract: an alive triangle's rect lies in the grid and c = rx * ry."""
    if meta.shape[0] != 4:
        raise ValueError(f"meta has {meta.shape[0]} rows, expected 4")
    if meta.device.type == "cpu":
        return bin_tiles_meta_plain(meta, ntx, nty, pair_cap, tile_cap, acc)
    if meta.device.type != "cuda":
        raise ValueError(f"bin_tiles_meta: no kernel for device {meta.device}")
    if not dense_layout(ntx, nty, tile_cap, meta.shape[1]):
        return _bin_tiles_flat_cuda(meta, ntx, nty, pair_cap, tile_cap, acc)
    return _bin_tiles_cuda(meta, ntx, nty, tile_cap, acc)



def default_pair_cap(num_triangles: int, num_tiles: int) -> int:
    """Static pair capacity heuristic (total pairs; overflow is detected and
    retried at the reported need)."""
    return max(2 * num_triangles, num_tiles, 2048)


# ---------------------------------------------------------------------------
# The micro half: (8x8 cell, triangle) pairs for the mega-scene path
# ---------------------------------------------------------------------------

def default_pair_cap_micro(num_triangles: int, num_cells: int) -> int:
    """Micro-path pair capacity: mega scenes cull most triangles and the
    survivors cover about one cell each, so 3T/8 leaves slack; an
    underestimate is reported and retried at the exact need."""
    return max(num_triangles * 3 // 8, num_cells, 32768)


def expand_cells_meta(c, rx, x0, y0, ntx_t: int, num_cells: int,
                      pair_cap: int):
    """(cell_of_pair, tri_of_pair, total_pairs) from per-triangle cover
    meta: cover count ``c`` (0 for culled), rect width ``rx`` and rect
    origin ``x0``/``y0`` in cell coordinates — the front end's meta rows at
    (8, 8). CPU tensors take ``expand.expand_cells_plain``, CUDA tensors the
    kernel (``expand.expand_cells``)."""
    from compute_renderer_torch.backends import expand

    return expand.expand_cells(c, rx, x0, y0, pair_cap=pair_cap,
                               ntx_t=ntx_t, num_cells=num_cells)


def segments_from_sorted_cells(sorted_cell, num_cells: int, num_tiles: int):
    """Per-cell segments of the cell-sorted pair list: (seg_start,
    seg_count, tile_count, win_start), from num_cells + 1 searchsorted
    boundaries (the sentinel tail sorts past every real cell).
    ``win_start`` is the 16-aligned base of each tile's first segment."""
    bounds = torch.searchsorted(
        sorted_cell.contiguous(),
        torch.arange(num_cells + 1, dtype=I32, device=sorted_cell.device),
        side="left", out_int32=True)
    seg_start = bounds[:-1]
    counts = bounds[1:] - bounds[:-1]
    return (seg_start, counts) + _cell_tiles(counts, seg_start, num_tiles)


def _cell_tiles(counts, seg_start, num_tiles: int):
    """(tile_count, win_start) of the cells' segments, 16 cells a tile:
    each tile's summed counts and the 16-aligned base of its first
    segment."""
    tile_count = counts.reshape(num_tiles, 16).sum(dim=1, dtype=I32)
    first = seg_start.reshape(num_tiles, 16)[:, 0]
    return tile_count, torch.div(first, 16, rounding_mode="floor") * 16


def bin_cells_sort_meta(c, rx, x0, y0, ntx_t: int, nty_t: int,
                        pair_cap: int, acc=None):
    """Cell-granularity binning for the micro path, from cover meta.

    Cells are 8x8 px and an (8, 128) tile holds 16 side by side; cell ids
    are ``(cy * ntx_t + cx // 16) * 16 + cx % 16`` — which equals the
    row-major id ``cy * 16 * ntx_t + cx`` — so one tile's 16 segments are
    contiguous in the sorted list. One stable sort by cell id carries the
    triangle ids, so each cell keeps ascending triangle order. The only
    capacity is ``pair_cap``; ``pair_needed`` reports the exact total when
    it overflows.

    Returns a dict: ``pair_tri`` (pair_cap,) triangle ids sorted by cell
    (defined on [0, min(total, pair_cap))), ``seg_start`` / ``seg_count``
    (num_cells,), ``win_start`` / ``tile_count`` (num_tiles,),
    ``total_pairs``, ``pair_needed`` and ``tile_needed`` (always 0: no
    per-tile cap), ``most`` (the largest cell count), and the
    occupied-tile ``worklist`` (num_tiles,) with ``k`` and the (2,)
    ``overflow`` report, folded into ``acc`` (the module docstring). CPU
    tensors take the twins (``expand.expand_cells_plain``,
    ``bin_sort_plain``), CUDA tensors the kernels (``csrc/expand.cu``,
    ``csrc/sort.cu``)."""
    num_tiles = ntx_t * nty_t
    num_cells = num_tiles * 16
    cell_of_pair, tri_of_pair, total = expand_cells_meta(
        c, rx, x0, y0, ntx_t, num_cells, pair_cap)
    bins = bin_sort(cell_of_pair, tri_of_pair, total, num_cells, group=16,
                    acc=acc)
    bins["layout"] = "micro"
    return bins


def bin_cells_sort(setup, ntx_t: int, nty_t: int, pair_cap: int):
    """``bin_cells_sort_meta`` from a ``triangle_setup`` dict computed at
    (8, 8): tile ranges are cell ranges."""
    rx, _, c = cover_counts(setup)
    return bin_cells_sort_meta(c, rx, setup["tile_x0"].to(I32),
                               setup["tile_y0"].to(I32), ntx_t, nty_t,
                               pair_cap)


def default_tile_cap(num_triangles: int, width: int, height: int,
                     tile_h: int, tile_w: int) -> int:
    """Per-tile capacity C — the reference's heuristic
    max(2 * tile_area / avg_tri_area, 128) (gpu_buffers.rs:53-63), rounded
    to a multiple of 8."""
    avg_tri_area = (width * height) / max(num_triangles, 1)
    base = int(2.0 * (tile_h * tile_w) / max(avg_tri_area, 1e-6))
    cap = max(base, 128)
    return (cap + 7) // 8 * 8
