"""Tracing and per-layer timing of the port on the card.

Counterpart of the JAX package's ``bench/profiling.py``:

- ``trace(log_dir)``: a ``torch.profiler`` trace of host and device
  activity into ``log_dir`` (Chrome trace JSON, for Perfetto or
  TensorBoard);
- ``stage_timings``, ``stage_timings_micro``: the device time of each of
  the port's layers (PERF.md §3) alone — front, binning (the expansion
  split out on the micro path), raster — on one frame's inputs, each
  captured as its own CUDA graph and timed by CUDA events around
  back-to-back replays (``graph_ms``: no host launch gaps), plus
  ``total_fused_ms``, the renderer's whole frame as it replays it;
- ``stage_timings_deferred``: the deferred texture path against the same
  mesh without its textures, both as replayed graphs;
- ``profile_batch``, ``range_device_ms``, ``host_calls_per_frame``: where
  a batch's device time goes — busy time and kernels a frame, split by
  layer and by the texture ranges (``cuda.TEXTURE_RANGES``, seen only in
  eager frames: a replay records no ranges), and the host's CUDA calls a
  frame;
- ``stage_timings_sortmiddle``: the per-triangle chain of one sort-middle
  rank (``parallel/sharding.py``) on a 1/n slice of the triangles beside
  the same chain at full T;
- ``event_ms``, ``graph_ms``: the timers, and ``card_line``: the card's
  name and power limit, which every kept number names.

Every timing here is of the card and raises without one: a CPU run gives
no device time.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import subprocess
import time

import numpy as np
import torch

from compute_renderer_torch.backends import (
    binning, cuda, expand, front, micro, raster,
)
from compute_renderer_torch.engine.renderer import Renderer, unpack_uniforms

# The CUDA runtime and driver calls with which the host issues device
# work, as the profiler names them.
LAUNCH_CALLS = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
               "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them: a
    card may run below its 700 W, so every number kept names both."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0].strip()


def _require_cuda(device) -> torch.device:
    device = torch.device(device)
    if device.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            f"timing on {device} needs a CUDA card: a CPU run gives no "
            "device time")
    return device


def device_profile(**kwargs):
    """A torch.profiler session of the host and the card (``kwargs`` as
    ``torch.profiler.profile`` takes them). CUPTI stays set up between
    sessions (``TEARDOWN_CUPTI=0``), as torch keeps it for its own CUDA
    graphs ("CUDA Graph does not work well with CUPTI teardown",
    torch/profiler/profiler.py): the renderer replays graphs."""
    from torch.profiler import ProfilerActivity, profile

    os.environ["TEARDOWN_CUPTI"] = "0"
    kwargs.setdefault("activities", [ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA])
    return profile(**kwargs)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the host and, where there is a card, the device into
    ``log_dir`` (one ``*.pt.trace.json`` a trace). Yields the profiler."""
    from torch.profiler import ProfilerActivity, tensorboard_trace_handler

    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with device_profile(activities=activities,
                        on_trace_ready=tensorboard_trace_handler(
                            log_dir)) as prof:
        yield prof


def event_ms(fn, iters: int) -> float:
    """Mean ms a call of ``fn`` on the card's clock: CUDA events around
    ``iters`` back-to-back calls, after two warm-up calls."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int) -> float:
    """Device ms of ``fn``'s work: one eager call on a side stream, then
    ``fn`` captured as a CUDA graph whose replays ``event_ms`` times — the
    stage's device time without the host's launch gaps."""
    stream = torch.cuda.current_stream()
    side = torch.cuda.Stream()
    side.wait_stream(stream)
    with torch.cuda.stream(side):
        fn()
    stream.wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    return event_ms(graph.replay, iters)


def _frame_inputs(mesh, uniforms, device):
    """One frame's device tensors: corner-SoA geometry and the uniforms."""
    packed, L = Renderer.pack_uniforms(uniforms)
    vpos, vp, eff, lwp, lc, li = unpack_uniforms(
        torch.from_numpy(packed).to(device), L)
    pos = torch.as_tensor(mesh.positions, dtype=torch.float32, device=device)
    nrm = torch.as_tensor(mesh.normals, dtype=torch.float32, device=device)
    tri = torch.as_tensor(mesh.indices.astype(np.int32),
                          device=device).reshape(-1, 3)
    return (cuda.corner_soa(pos, tri), cuda.corner_soa(nrm, tri), vp, vpos,
            eff, lwp, lc, li)


def _fused_ms(mesh, uniforms, width, height, device, iters, **options):
    """Device ms of the renderer's whole frame: back-to-back replays of
    its graph, after a checked frame has settled the capacities."""
    renderer = Renderer(mesh, width, height, device=device, **options)
    renderer.render(uniforms)
    return event_ms(renderer.frame_graph(uniforms).graph.replay, iters)


def stage_timings(mesh, uniforms, width: int, height: int,
                  tile_h: int = 16, tile_w: int = 256, iters: int = 20,
                  device="cuda") -> dict:
    """Device ms of the tile path's layers on one frame — ``front_ms``
    (vertex, setup and the coefficient table: one kernel),
    ``binning_ms``, ``raster_shade_ms`` — and ``total_fused_ms``, the
    frame as the renderer replays it, at the tile shape given."""
    device = _require_cuda(device)
    pos_soa, nrm_soa, vp, vpos, eff, lwp, lc, li = _frame_inputs(
        mesh, uniforms, device)
    T = pos_soa.shape[2]
    caps = cuda.default_caps("tile", T, width, height, tile_h, tile_w)
    ntx = (width + tile_w - 1) // tile_w
    nty = (height + tile_h - 1) // tile_h

    def run_front():
        return front.front_end(pos_soa, nrm_soa, vp, eff, width=width,
                               height=height, tile_h=tile_h, tile_w=tile_w)

    table, meta = run_front()
    # Capacities at this frame's exact need, as the renderer's retry
    # settles them.
    need = binning.exact_tile_counts(binning.setup_from_meta(meta), ntx,
                                     nty)
    pc = max(caps["pair_cap"], int(need.sum()))
    tc = min(max(caps["tile_cap"], int(need.max())), cuda.MAX_TILE_CAP)

    def run_bin():
        return binning.bin_tiles_meta(meta, ntx, nty, pc, tc)

    bins = run_bin()
    data = bins["bin_rows"] if bins["layout"] == "dense" else \
        bins["pair_tri"]

    def run_raster():
        return raster.raster_shade_tiles(
            table, data, bins["seg_start"], bins["seg_count"], eff, vpos,
            lwp, lc, li, height_padded=nty * tile_h,
            width_padded=ntx * tile_w, tile_h=tile_h, tile_w=tile_w,
            layout=bins["layout"], worklist=(bins["worklist"], bins["k"]),
            spans=bins.get("spans"))

    return {
        "front_ms": graph_ms(run_front, iters),
        "binning_ms": graph_ms(run_bin, iters),
        "raster_shade_ms": graph_ms(run_raster, iters),
        "total_fused_ms": _fused_ms(mesh, uniforms, width, height, device,
                                    iters, path="tile", tile_h=tile_h,
                                    tile_w=tile_w),
        "layout": bins["layout"],
    }


def stage_timings_micro(mesh, uniforms, width: int, height: int,
                        iters: int = 8, device="cuda") -> dict:
    """Device ms of the micro path's layers on one frame — ``front_ms``
    (8x8 cells), ``expand_ms`` (the pair expansion, both launches),
    ``binning_ms`` (the expansion and the bin sort: the cell-sorted pairs,
    segments and work list),
    ``raster_shade_ms`` — and ``total_fused_ms``, the replayed frame; the
    pair capacity is the renderer's calibrated one."""
    device = _require_cuda(device)
    pos_soa, nrm_soa, vp, vpos, eff, lwp, lc, li = _frame_inputs(
        mesh, uniforms, device)
    ntx, nty = (width + 127) // 128, (height + 7) // 8
    num_cells = ntx * nty * 16

    def run_front():
        return front.front_end(pos_soa, nrm_soa, vp, eff, width=width,
                               height=height, tile_h=8, tile_w=8)

    table, meta = run_front()
    pair_cap = cuda.grow_pair_cap(0, max(int(meta[3].sum()), num_cells,
                                         1024))

    def run_expand():
        return expand.expand_cells(meta[3], meta[2], meta[0], meta[1],
                                   pair_cap=pair_cap, ntx_t=ntx,
                                   num_cells=num_cells)

    def run_bin():
        return binning.bin_cells_sort_meta(meta[3], meta[2], meta[0],
                                           meta[1], ntx, nty, pair_cap)

    bins = run_bin()

    def run_raster():
        return micro.raster_shade_micro(
            table, bins["pair_tri"], bins["seg_start"], bins["seg_count"],
            bins["tile_count"], eff, vpos, lwp, lc, li,
            height_padded=nty * 8, width_padded=ntx * 128,
            worklist=(bins["worklist"], bins["k"]))

    return {
        "front_ms": graph_ms(run_front, iters),
        "expand_ms": graph_ms(run_expand, iters),
        "binning_ms": graph_ms(run_bin, iters),
        "raster_shade_ms": graph_ms(run_raster, iters),
        "total_fused_ms": _fused_ms(mesh, uniforms, width, height, device,
                                    iters, path="micro"),
        "pair_cap": pair_cap,
    }


def stage_timings_sortmiddle(mesh, uniforms, width: int, height: int,
                             n_shards: int, iters: int = 8,
                             device="cuda") -> dict:
    """Device ms of the per-triangle chain one sort-middle rank runs
    (``parallel.sharding._stripe_sortmiddle``: the front at 8x8 cells,
    the pair expansion, the stable cell sort) on the first ``ceil(T /
    n_shards)`` triangles (``front_slice_ms``), beside the same chain at
    full T (``front_full_ms``), each a replayed graph; ``speedup`` is their
    ratio (n_shards where the chain is O(T / n)). The exchange, the table
    gather and the stripe's raster, which do not scale with T, are not in
    it. Pair capacities are each chain's own need."""
    device = _require_cuda(device)
    pos_soa, nrm_soa, vp, _, eff, *_ = _frame_inputs(mesh, uniforms, device)
    T = pos_soa.shape[2]
    Tl = -(-T // n_shards)
    ntx, nty = (width + 127) // 128, (height + 7) // 8
    num_cells = ntx * nty * 16

    def chain(count):
        pos = pos_soa[..., :count].contiguous()
        nrm = nrm_soa[..., :count].contiguous()
        _, meta = front.front_end(pos, nrm, vp, eff, width=width,
                                  height=height, tile_h=8, tile_w=8)
        pair_cap = cuda.grow_pair_cap(0, max(int(meta[3].sum()), 1024))

        def run():
            _, meta = front.front_end(pos, nrm, vp, eff, width=width,
                                      height=height, tile_h=8, tile_w=8)
            cell, tri, _ = expand.expand_cells(
                meta[3], meta[2], meta[0], meta[1], pair_cap=pair_cap,
                ntx_t=ntx, num_cells=num_cells)
            cell, order = torch.sort(cell, stable=True)
            return cell, tri[order]

        return graph_ms(run, iters)

    t_slice, t_full = chain(Tl), chain(T)
    return {"n_shards": n_shards, "front_slice_ms": t_slice,
            "front_full_ms": t_full, "speedup": t_full / max(t_slice, 1e-9)}


def stage_timings_deferred(mesh, uniforms, width: int, height: int,
                           tex_filter: str = "nearest", iters: int = 8,
                           device="cuda") -> dict:
    """Device ms of a textured mesh's deferred frame (``vis_walk_ms``:
    the vis-mode raster and the deferred tail) against the same mesh
    without its textures (``fused_plain_ms``: shaded in the raster), both
    as replayed graphs, and their difference, the cost of deferred
    texturing under ``tex_filter`` (the mip pool is built once, outside
    the timing)."""
    device = _require_cuda(device)
    if not getattr(mesh, "has_textures", False):
        raise ValueError("stage_timings_deferred needs a textured mesh")
    plain = dataclasses.replace(mesh, face_tex=None, texels=None,
                                tex_table=None)
    t_plain = _fused_ms(plain, uniforms, width, height, device, iters)
    t_vis = _fused_ms(mesh, uniforms, width, height, device, iters,
                      tex_filter=tex_filter, tex_mode="deferred")
    return {
        "fused_plain_ms": t_plain,
        "vis_walk_ms": t_vis,
        "deferred_overhead_ms": t_vis - t_plain,
        "tex_filter": tex_filter,
    }


def range_device_ms(events, name):
    """(device ms, kernels) of every kernel launched inside the
    torch.profiler ranges named ``name``, summed over ``events``
    (prof.events()): the kernels each range's ops launched, found through
    their CPU children."""
    cpu = torch.autograd.DeviceType.CPU
    total_us, count = 0.0, 0
    stack = [e for e in events
             if e.name == name and getattr(e, "device_type", cpu) == cpu]
    while stack:
        e = stack.pop()
        for k in getattr(e, "kernels", ()):
            total_us += k.duration
            count += 1
        stack.extend(e.cpu_children)
    return total_us / 1e3, count


def _launch_calls(events) -> int:
    """The host's CUDA calls that issue device work, among ``events``."""
    return sum(1 for e in events if e.name.startswith(LAUNCH_CALLS))


def profile_batch(renderer, batch, layers, eager: bool = False) -> dict:
    """Where a batch's device time goes: one profiled
    ``render_batch_device`` of ``batch`` (unchecked, fenced), replayed
    graphs or, with ``eager``, the eager loop. Returns per frame:
    ``busy_ms`` (every kernel and copy on the card), ``kernels``,
    ``launch_calls`` (the host's launch, graph-launch, copy and set calls,
    per-batch ones included), ``by_layer`` ({layer: ms}, ``layers`` mapping
    a layer to substrings of its kernels' names, the rest "other", the
    texture ranges split out of "other" where the batch records them),
    ``texture_kernels`` ({range: kernels}); and ``wall_ms`` (the batch,
    profiler on), ``rows`` (the top kernels: ms a frame, count, name) and
    ``frames``."""
    _require_cuda(renderer.device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with device_profile() as prof:
        renderer.render_batch_device(batch, check=False, eager=eager)
        renderer.fence_pending()
    wall = (time.perf_counter() - t0) * 1e3
    averages = prof.key_averages()
    events = prof.events()
    n = len(batch)
    # Device rows only: the aten rows repeat their kernels' time, and a
    # range's device row (its annotation) spans its kernels.
    cuda_type = torch.autograd.DeviceType.CUDA
    rows = []
    for ev in averages:
        if (getattr(ev, "device_type", None) != cuda_type
                or ev.key in cuda.TEXTURE_RANGES):
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        rows.append((dev / 1e3 / n, ev.count, ev.key))
    rows.sort(reverse=True)
    by_layer = dict.fromkeys(layers, 0.0)
    by_layer["other"] = 0.0
    for ms, _, key in rows:
        layer = next((name for name, keys in layers.items()
                      if any(k in key.lower() for k in keys)), "other")
        by_layer[layer] += ms
    texture_kernels = {}
    recorded = {e.name for e in events if e.name in cuda.TEXTURE_RANGES}
    for name in cuda.TEXTURE_RANGES:
        if name not in recorded:  # a graph's replay records no range
            continue
        ms, count = range_device_ms(events, name)
        ms, count = ms / n, count / n
        # The range's texture stage kernels, which no torch op launches.
        for row_ms, row_count, key in rows:
            if any(s in key for s in cuda.TEXTURE_RANGE_KERNELS[name]):
                ms, count = ms + row_ms, count + row_count / n
        if count:
            by_layer[name.replace("_", " ")] = ms
            by_layer["other"] -= ms
            texture_kernels[name] = count
    return {
        "frames": n, "wall_ms": wall,
        "busy_ms": sum(r[0] for r in rows),
        "kernels": sum(r[1] for r in rows) / n,
        "launch_calls": _launch_calls(events) / n,
        "by_layer": by_layer, "texture_kernels": texture_kernels,
        "rows": rows,
    }


def host_calls_per_frame(renderer, make_batch, eager: bool = False,
                         frames: int = 8):
    """The host's CUDA calls that issue device work (kernel and graph
    launches, copies, sets) a frame of ``render_batch_device``: the
    profiler's count over a batch of 2 x ``frames`` less that over a
    batch of ``frames``, over ``frames``, so the per-batch calls cancel.
    ``make_batch(n)`` gives n frames' uniforms. None when the profiler
    records no such call."""
    _require_cuda(renderer.device)
    counts = []
    for n in (frames, 2 * frames):
        batch = make_batch(n)
        renderer.render_batch_device(batch, check=False, eager=eager)
        renderer.fence_pending()
        with device_profile() as prof:
            renderer.render_batch_device(batch, check=False, eager=eager)
            renderer.fence_pending()
        counts.append(_launch_calls(prof.events()))
    if not counts[1]:
        return None
    return (counts[1] - counts[0]) / frames
