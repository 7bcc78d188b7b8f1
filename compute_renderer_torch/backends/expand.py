"""Pair expansion for the micro path: per-triangle cover meta -> the
(cell, triangle) pair list that the binning sort orders by cell.

Counterpart of the JAX package's ``backends/pallas_expand.py``
(``expand_cells``). Triangle t owns the pair slots
``[starts[t], starts[t] + c[t])`` (``starts`` = exclusive cumsum of ``c``);
slot ``starts[t] + local`` covers the cell at
``(x0[t] + local % rx[t], y0[t] + local // rx[t])`` of the triangle's cell
rectangle, whose id is ``(cy * ntx_t + cx // 16) * 16 + cx % 16``.

Contract of ``expand_cells``, kernel and twin alike: ``cell_of_pair`` and
``tri_of_pair`` are exact on ``[0, min(total, pair_cap))``; every cell slot
beyond holds the ``num_cells`` sentinel (so it sorts past every real cell);
``total`` is the exact pair count even when it exceeds ``pair_cap`` (it
drives the capacity retry). The tail's ``tri_of_pair`` is unspecified: the
kernel writes 0 there, the twin the last owner; nothing reads it.

A CUDA tensor runs the hand-written kernel ``csrc/expand.cu`` (two
launches, the scan of ``c`` included: block sums, then the block-local
scan and expansion); a CPU tensor runs ``expand_cells_plain``.
"""

from __future__ import annotations

import torch

from compute_renderer_torch import tracing

from compute_renderer_torch.backends import binning

I32 = torch.int32
# Triangles an expansion block owns (csrc/expand.cu's TRIS): the length
# of the kernel's block-sum scratch is ceil(T / TRIS).
TRIS = 1024


def expand_cells_plain(c, rx, x0, y0, *, pair_cap: int, ntx_t: int,
                       num_cells: int):
    """The twin: owners by scatter + running max
    (``binning.expand_pair_owners``), then the rect walk of each pair."""
    device = c.device
    c = c.to(I32)
    starts = torch.cumsum(c, 0, dtype=I32) - c
    total = c.sum(dtype=I32)
    if c.shape[0] == 0:
        return (torch.full((pair_cap,), num_cells, dtype=I32, device=device),
                torch.zeros((pair_cap,), dtype=I32, device=device), total)
    p = torch.arange(pair_cap, dtype=I32, device=device)
    tri_of_pair = binning.expand_pair_owners(starts, c, pair_cap)
    owner = tri_of_pair.long()
    local = p - starts[owner]
    trx = torch.clamp(rx.to(I32)[owner], min=1)
    cx = x0.to(I32)[owner] + torch.remainder(local, trx)
    cy = y0.to(I32)[owner] + torch.div(local, trx, rounding_mode="floor")
    cell = ((cy * ntx_t + torch.div(cx, 16, rounding_mode="floor")) * 16
            + torch.remainder(cx, 16))
    cell = torch.where(p < total, cell, num_cells).to(I32)
    return cell, tri_of_pair, total


def _expand_cuda(c, rx, x0, y0, *, pair_cap, ntx_t, num_cells,
                 row_width=None):
    """The kernel: cell ids as the micro path numbers them, or with
    ``row_width`` the row-major ids ``cy * row_width + cx`` (the tile
    path's flat layout, ``binning.bin_tiles_meta``)."""
    from compute_renderer_torch import _build

    device = c.device
    T = c.shape[0]
    c, rx, x0, y0 = (a.to(I32).contiguous() for a in (c, rx, x0, y0))
    blocks = -(-T // TRIS)
    sums = torch.empty((blocks,), dtype=I32, device=device)
    total = torch.empty((1,), dtype=I32, device=device)
    cell = torch.empty((pair_cap,), dtype=I32, device=device)
    tri = torch.empty((pair_cap,), dtype=I32, device=device)
    fn = _build.entry("expand", "expand_rows_i32", pointers=8, ints=5)
    tracing.launch("expand_cells")
    _build.check(
        fn(c.data_ptr(), rx.data_ptr(), x0.data_ptr(), y0.data_ptr(),
           sums.data_ptr(), total.data_ptr(), cell.data_ptr(),
           tri.data_ptr(), T, blocks, pair_cap,
           16 * ntx_t if row_width is None else row_width, num_cells,
           torch.cuda.current_stream(device).cuda_stream),
        "expand_cells",
    )
    return cell, tri, total[0]


def expand_cells(c, rx, x0, y0, *, pair_cap: int, ntx_t: int,
                 num_cells: int):
    """(cell_of_pair (pair_cap,) i32, tri_of_pair (pair_cap,) i32, total
    () i32) from (T,) cover meta; see the module docstring for the
    contract. CPU tensors take the twin, CUDA tensors the kernel
    (``launches.expand_cells`` counts its calls, two launches each; a
    CUDA graph's capture ticks it, its replays do not)."""
    kw = dict(pair_cap=pair_cap, ntx_t=ntx_t, num_cells=num_cells)
    if c.device.type == "cpu":
        return expand_cells_plain(c, rx, x0, y0, **kw)
    if c.device.type != "cuda":
        raise ValueError(f"expand_cells: no kernel for device {c.device}")
    return _expand_cuda(c, rx, x0, y0, **kw)

