#!/usr/bin/env python3
"""Smoke run of the PyTorch port (compute_renderer_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device — requires CUDA; prints the card's name and power limit;
2. build — compiles the seven hand-written kernel sources (csrc/*.cu)
   with nvcc, one process per source, all at once;
3. kernel vs twin, tile path — the front end and the raster on the tile
   path's inputs (Suzanne and san_miguel_small at 1024x768, and a wave
   frame): meta bitwise, the (T, R) table bitwise with NaN positions equal
   (<= 1 ULP on the wave frame, whose sinf inputs differ) and in the
   layout the rasters take without a copy, the raster (fed the front's own
   table) with keys bitwise and RGBA within 1 LSB, dense and flat layouts;
   the tile path's binning kernel (bin_tiles_dense, csrc/bins.cu) against
   its twin, every output bitwise (the whole bin_rows, segments, work
   list, its count, the total and the overflow report), on the synthetic
   cases of tests/test_torch_tile_bins.py and on Suzanne's meta at both
   tuner tile shapes, whole and as a chunk view; after phase 8 loads it,
   the kernel called directly on structured_scene_tex's meta against the
   dense twin; the shading parameters (shading_params) bitwise in the
   plain, voxelize, edge-melt and mirage effects, with and without a row
   offset; each kernel's time beside its twin's at Suzanne's shapes;
4. kernel vs twin, micro path — the front end at 8x8 cells (meta and
   table bitwise), the pair expansion (bitwise on the valid range,
   the sentinel tail, total equal, an overflowing capacity included; and
   at San Miguel's triangle count one triangle of 40,000 cells among
   single-cell ones, within and past the capacity) and
   the micro raster (keys bitwise, RGBA within 1 LSB) on the San Miguel
   stand-in (998,784 triangles), san_miguel_small forced onto the micro
   path, a mirage frame and a voxelize frame, and the bin sort
   (csrc/sort.cu) on each case's expanded pairs, bitwise with its twin;
   each kernel's time beside its twin's at San Miguel's shapes (beside
   the expansion, torch.repeat_interleave of its triangle ids; beside
   the bin sort, torch.sort(stable) with the gather and the searchsorted
   it replaces);
5. main path, tile — bench.py's scene through Scene.from_config ->
   Renderer -> three render() frames (the first tunes the tile shape,
   capturing each candidate's CUDA graph; the frames replay the
   winner's): the front, binning, shading-parameter and raster launch
   counts advance, no overflow,
   and every frame matches
   tests/golden_data/torch_slice_suzanne_1024x768.npz (rendered by the JAX
   package) with at most max(2, H*W/500) pixels differing by more than
   2 LSB, and equals the eager loop's frame bitwise; the tuner's timings
   and pick; then the eager loop against the graph (``compare_eager_graph``:
   ms/frame by bench.py's batch-slope method, 64 and 256 frames, best of
   4, the two in turns; the host's CUDA calls a frame, at most 3 through
   the graph; one profiled batch of each, busy time, kernels and idle
   share, the binning and shading kernels as layers of their own); the
   graph's kernels a frame, at most 12;
6. main path, micro — the San Miguel benchmark configuration through
   Renderer: calibration, one capture, three frames against
   tests/golden_data/torch_micro_san_miguel_1024x768.npz and bitwise
   against the eager frames, the front, expand, bin sort and micro launch
   counts advance and the tile raster's stays 0, no overflow, the micro
   merge scratch clear after the replays; the eager loop against the
   graph, the eager profile split into front / expand / bin sort / micro
   / other; no main path's graph runs torch's sort, searchsorted or
   running max (every compare_eager_graph row);
7. san_miguel_small on the tile path against the CPU twin path, with the
   tuner's pick, the flat layout's bin sort launched and its graph
   profiled (no torch sort in it);
8. the structured scenes of the reference suite's extension rows
   (bench/suite.py:101-144), synthesized (io/objgen.py) and loaded from
   disk through Model.load (the native parser, io/native.py) once each
   (structured_scene.obj, 1,023,442 triangles, and
   structured_scene_tex.obj, 36,322), with textures; the materials rows
   drop the atlas (the Kd rows are the same); each file parsed again by
   the native parser and by the Python loader (io/obj.py), every array
   (positions, normals, uvs, indices, face_kd, face_tex, texels,
   tex_table) equal, the seconds of each parse printed; then the bin
   sort (csrc/sort.cu) and the deferred vertex stage (csrc/texture.cu
   vertex_stage_kernel) against their twins, bitwise: the cases of
   tests/test_torch_bin_sort.py on both layouts with the stress segment
   of SORT_STRESS pairs (across several of the kernel's chunks), pair
   and tile overflow, one bin holding every pair and every pair in a bin
   of its own; the micro layout on structured_scene.obj within and past
   its pair capacity; the flat layout (the expansion in
   row-major tile ids, then the sort) on structured_scene_tex.obj and
   san_miguel_small at both tuner tile shapes, at the default caps, the
   frame's exact need and half its pairs; the vertex stage on structured
   +deferred trilinear's frame and a wave frame; the vertex stage's and
   the flat sort's times beside their twins' (the flat sort also beside
   torch.sort(stable) + gather + two searchsorted) and each bin_sort
   kernel's time ([sort] lines);
9. kernel vs twin, material and fused-texture modes — the front end at
   8x8 and 16x256 (meta bitwise, coefficients 0 ULP), the tile raster on
   structured_scene_tex and a mirage frame of it (both layouts) and the
   micro raster on structured_scene.obj and the mirage frame: keys
   bitwise, RGBA within 1 LSB (mat), the G-buffer bitwise (texf; the
   max ULP is printed if not); on each raster's own G-buffer (its frame
   window, read in place) the fused tail kernel (csrc/texture.cu
   texture_tail, nearest and bilinear, the f32 and the u8-packed pool)
   against its plain version, RGBA within 1 LSB with the differing
   pixels printed; each mode kernel's time beside its twin's at its main
   path's shapes, texture_tail's at the +textures row's (micro,
   1024x768);
10. main paths, extension rows — through Scene -> Renderer ->
   render_batch_device: structured_scene.obj +materials and +textures
   (micro path, three frames each), structured_scene_tex.obj +textures
   (tile path, three frames), + bilinear and SSAA 2 (one frame) and
   +materials (the tile raster's material mode, three frames), each frame
   within the pixel contract of
   tests/golden_data/torch_ext_structured_1024x768.npz and bitwise equal
   to the eager frame, no overflow, and each mode kernel of the row's path
   launched (per-mode counts; texture_tail on the texf rows, no texture
   stage on the others); the bin sort launched on every row (the micro
   rows' cells, the tile rows' flat layout), and each tile row's graph
   profiled with the flat bin sort as a layer and no torch sort in it;
   the tuner's pick on the tile rows; the eager loop against the graph
   on the two micro rows;
11. kernel vs twin, visibility (vis) and mip-filtered texture (texf_mip)
   modes — the front end's texf_mip at 8x8 and 16x256 (meta bitwise,
   coefficients 0 ULP), the tile raster on structured_scene_tex and its
   mirage frame (both layouts) and the micro raster on
   structured_scene.obj and the mirage frame: keys and vis ids / pair
   indices bitwise, the texf_mip G-buffer bitwise; on each raster's own
   output the texture stages against their plain versions: mip_rows
   bitwise (and on wave frames of both scenes within 1 ULP), the fused
   mip tail (texture_tail_mip, trilinear and anisotropic) and the deferred
   tail (deferred_tail, all four filters, the micro path's pair indices
   mapped through its pair list) with RGBA within 1 LSB; each mode
   kernel's time beside its twin's at its main path's shapes, the
   texture stages' at the micro rows' (texture_tail_mip trilinear and
   anisotropic, deferred_tail trilinear and nearest, mip_rows over
   1,023,442 triangles);
12. main paths, mip and deferred rows — the six rows of
   tests/golden_data/torch_mip_structured_1024x768.npz (trilinear,
   anisotropic and tex_mode="deferred" on structured_scene_tex.obj, tile
   path; trilinear, anisotropic and deferred trilinear on
   structured_scene.obj, micro path) through Scene -> Renderer ->
   render_batch_device, each within the pixel contract and bitwise equal
   to the eager frames, no overflow, its mode kernels launched and the
   other path's raster never (texture_tail_mip and mip_rows on the fused
   rows, deferred_tail, vertex_stage and, under a mip filter, mip_rows
   on the deferred rows; the bin sort on every row, the tile rows' graphs
   profiled as in phase 10), the tuner's pick on the tile rows; then the
   fused and deferred images of one frame bitwise equal (micro: trilinear
   and anisotropic; tile: trilinear, else at most 1 LSB, the differing
   pixels printed), and the eager loop (16 and 64 frames) against the
   graph on the micro trilinear, anisotropic and deferred rows, the eager
   profile with the texture work split out;
13. stress — card tensors built directly (no front end) at 256x64: a
   cell of over 20 x micro.SPAN coplanar duplicates (equal keys straddle
   the spans), NaN / infinite coefficients and -0.0 depth planes inside
   split cells under voxelize, and triangles whose integer edges run along
   the tile raster's sub-rectangle borders, plain and under mirage; every
   mode of both rasters (both tile layouts) against its twin: keys, ids,
   pair indices and G-buffers bitwise, RGBA within 1 LSB; and a texf and
   a texf_mip G-buffer with NaN uv (and lod) in the uncovered and
   untextured pixels, negative uv and uv past 1, through both fused tails
   in every filter (both pools), RGBA within 1 LSB.

14. graph — the eager-against-graph numbers of every main-path row
   together, the tuner's picks, and ``bench_torch.py`` run once (its JSON
   line printed);
15. comparators — backends/xla.py and backends/wgpu_faithful.py at
   1024x768 through Renderer: the xla and wgpu-faithful frames of Suzanne
   and Exterior at their suite cameras and the xla frame of
   structured_tex +textures within the pixel contract of
   tests/golden_data/torch_comparators_1024x768.npz (the JAX package's
   frames; the xla winner ids against its ids, as many allowed to
   differ), the xla frame against the engine's on Suzanne, Exterior,
   san_miguel_small and structured_tex +textures (the pixel contract, the
   counts printed), ms/frame of each, no engine kernel launched (the four
   texture stages' counters included); xla at
   chunks of 16, 64 and 256 on three scenes, bitwise equal, with ms/frame
   and peak memory;
16. entry points — ``python3 -m compute_renderer_torch.cli`` in a
   subprocess (three orbit frames, one wave-effect frame, 1024x768, the
   PNGs decoded with zlib), then the 21 rows of bench/suite.py through
   run_suite at 1024x768, one call a row: the engine rows at batch 16
   (64 recorded frames) and at batch 1 (32), the comparator rows one
   recorded frame each; every row's JSON printed (backend, triangles,
   frames, ms/frame, FPS and lows, tail_source, overflow, launches, peak
   memory, seconds); no overflow and at least one frame in every row;
   each engine row launched its path's kernels, no comparator row any.
   The big comparator rows after San Miguel xla run only while the
   script is younger than SUITE_BIG_BUDGET_S; a row left out is printed.
17. multi-device — compute_renderer_torch/parallel/ on four ranks that
   share the card (backend "gloo", an explicit choice; spawned by
   ``parallel.launch``, the scenes handed over as CPU tensors): tile
   stripes of Suzanne (plain and mirage), micro stripes and sort-middle of
   San Miguel, structured +textures on micro stripes and structured
   +deferred trilinear on sort-middle, 16 frame-parallel frames of Suzanne
   (wave) and of San Miguel, the 2 x 2 frames x stripes layout; each frame
   and its keys bitwise equal to the single-device renderer's, on every
   rank; the textured rows within the golden pixel contract; each rank's
   launch counts show its path's kernels, each frame-parallel rank
   replayed its own graph; then sort-middle of San Miguel in a
   world-size-1 NCCL group, bitwise too (bucket_cap and the gathered
   table's size printed); ms/frame of each decomposition at n = 1, 2, 4
   (host clock, fenced: not scaling numbers, the ranks share one card)
   and ``stage_timings_sortmiddle`` at n = 4, each with the card line.
18. viewers and oracle — app/window.py through a fake Tk at a fixed
   clock (dt = 1/60), 1024x768: Suzanne (tile path) and the San Miguel
   stand-in (micro path), 200 ticks each with w held and a mouse drag;
   every tick one blocking wait and no checked render, no overflow, every
   presented frame bitwise a second renderer's render of the previous
   tick's uniforms, the kernels of both paths launched by the ticks;
   ticks/s and the host split a tick (dispatch, wait, blit).
   app/webview.py on an ephemeral port driven with urllib (page, a key, a drag, 100 ticks, a
   resize to 640x480, /stats, /quit): every served PNG (decoded with
   zlib) bitwise the render of the uniforms it shows — a frame whose
   unchecked render a later flush reports as overflowing (the viewers'
   design: dropped triangles shown until that flush) is counted and
   printed, and that flush's checked render is held bitwise; ticks/s and
   the PNG encode. The CLI's ``--interactive --frames 2`` (headless
   fallback, both PNGs) and ``--web 0`` (a frame, exit 0 on /quit) in
   subprocesses. The NumPy oracle (golden/) against the card's frames,
   tile and micro paths: tests/test_fuzz.py's soups at 128x48 (at most
   0.5% of pixels more than 1 LSB off), its pinhole frame (no background
   pixel inside the silhouette) and tests/test_golden.py's depth order,
   depth tie, backface, near plane and two lights (each case's own
   assertion, and the soups' gate); the pixel counts printed.

The suite rows and the CLI drive the kernels through the public entry
points; the kernels' record below keeps the counts of phases 5, 6, 10
and 12 (each main path's own run; the texture stages' counters stay 0 on
the untextured rows of phases 5, 6 and 10), and every kernel is held to
its twin in phases 3, 4, 9, 11 and 13.

Every main path runs its rasters on the front's own table: no
``raster.kernel_table`` copy is counted in phases 5, 6, 10 and 12. On
the card each frame of a main path is a replayed CUDA graph; a kernel
wrapper's launch count ticks when the graph is captured (and at the
eager warm-up before it), never at a replay, so a main path's counts are
those of its captures.

A kernel's time is the device time of all its launches in one call
(torch.profiler; the expansion's two launches together). Beside each
raster time the script prints what the walk covers: the longest tile
list, the cull's survivors and the samples walked (tile), the densest
cell, the cells over SPAN pairs and their spans (micro).

Prints the kernels' JSON record (one entry per kernel and mode) and the
card line before the last line, and as the last line
{"ok": true, "device": {...}}.
"""

import copy
import dataclasses
import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1024, 768
DT = 1.0 / 60.0
BATCH_SMALL, BATCH_LARGE, ROUNDS = 64, 256, 4  # bench.py's batch slope
# The eager loop's batches on the rows whose eager frame takes 7-18 ms.
SLOW_EAGER_BATCHES = (16, 64)
GOLDEN = os.path.join(ROOT, "tests", "golden_data",
                      "torch_slice_suzanne_1024x768.npz")
GOLDEN_MICRO = os.path.join(ROOT, "tests", "golden_data",
                            "torch_micro_san_miguel_1024x768.npz")
GOLDEN_EXT = os.path.join(ROOT, "tests", "golden_data",
                          "torch_ext_structured_1024x768.npz")
GOLDEN_MIP = os.path.join(ROOT, "tests", "golden_data",
                          "torch_mip_structured_1024x768.npz")
SAN_MIGUEL = "San_Miguel/san-miguel-low-poly.obj"
SAN_MIGUEL_EYE = (13.566635, 2.6288567, 10.243919)  # bench/suite.py
STRUCTURED_EYE = (13.566635, 4.0, 24.0)  # bench/suite.py:98
# The card's peaks for the bounds (H100 SXM data sheet):
# HBM bytes/s and float32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# Operations per unit of work, counted from the sources: the front end
# per triangle (3 corner transforms, setup, 9 barycentric and 21
# interpolant coefficients); a raster sample per (pair, pixel) (two
# offsets, four (A + B dx) + C dy, four compares); the expansion per pair
# slot (a 10-step binary search of its block's starts and the rect walk,
# integer ops).
FRONT_OPS = 300
SAMPLE_OPS = 30
EXPAND_OPS = 60
# Table columns a raster's walk tests for every pair: the barycentric
# (9) and depth (3) triples and the anchor (2). The rest of a row is read
# only for a triangle that wins a pixel.
WALK_COLUMNS = 14
KERNELS = {
    "front_end": {
        "source": "compute_renderer_torch/csrc/front.cu",
        "replaces": ("pallas_front.py", "_front_kernel"),
        "symbol": "front_kernel",
    },
    "raster_shade_tiles": {
        "source": "compute_renderer_torch/csrc/raster.cu",
        "replaces": ("pallas_raster.py", "_raster_kernel_wl"),
        "symbol": "raster_kernel",
    },
    "expand_cells": {
        "source": "compute_renderer_torch/csrc/expand.cu",
        "replaces": ("pallas_expand.py", "_expand_kernel"),
        "symbol": "expand_kernel",
    },
    "raster_shade_micro": {
        "source": "compute_renderer_torch/csrc/micro.cu",
        "replaces": ("pallas_micro.py", "_micro_kernel_wl"),
        "symbol": "micro_kernel",
    },
    # The stages the JAX package leaves to XLA inside its compiled step:
    # the dense binning with its work list (binning.py setup_from_meta +
    # bin_triangles_dense, pallas_raster.py occupied_worklist), and the
    # rasters' shading parameters (built in pallas_raster.py
    # raster_shade_tiles and pallas_micro.py raster_shade_micro).
    "bin_tiles_dense": {
        "source": "compute_renderer_torch/csrc/bins.cu",
        "replaces": ("binning.py", "bin_triangles_dense"),
        "symbol": "bin_",  # bin_rows_kernel and bin_scan_kernel
    },
    "shading_params": {
        "source": "compute_renderer_torch/csrc/bins.cu",
        "replaces": ("pallas_raster.py", "raster_shade_tiles"),
        "symbol": "shading_params_kernel",
    },
    # The texture stages (csrc/texture.cu), which the JAX package fuses
    # with XLA ops: the fused tails, the deferred tail (common.py
    # resolve_attributes, then textured_shade) and the frame's mip rows
    # (vertex_stage -> uv_gradients -> mip_tri_rows).
    "texture_tail": {
        "source": "compute_renderer_torch/csrc/texture.cu",
        "replaces": ("common.py", "fused_texture_tail"),
        "symbol": "texture_tail_kernel",
    },
    "texture_tail_mip": {
        "source": "compute_renderer_torch/csrc/texture.cu",
        "replaces": ("common.py", "fused_texture_tail_mip"),
        "symbol": "texture_tail_mip_kernel",
    },
    "deferred_tail": {
        "source": "compute_renderer_torch/csrc/texture.cu",
        "replaces": ("common.py", "textured_shade"),
        "symbol": "deferred_tail_kernel",
    },
    "mip_rows": {
        "source": "compute_renderer_torch/csrc/texture.cu",
        "replaces": ("common.py", "mip_tri_rows"),
        "symbol": "mip_rows_kernel",
    },
    # The deferred mode's per-vertex stage (common.py vertex_stage), and
    # the bin sort (csrc/sort.cu) of the two sort layouts: the micro
    # path's cells (binning.py bin_cells_sort_meta's lax.sort and
    # segments, and its work list) and the tile path's flat layout
    # (binning.py bin_triangles_sort), its pairs from the expansion kernel.
    "vertex_stage": {
        "source": "compute_renderer_torch/csrc/texture.cu",
        "replaces": ("common.py", "vertex_stage"),
        "symbol": "vertex_stage_kernel",
    },
    "bin_sort": {
        "source": "compute_renderer_torch/csrc/sort.cu",
        "replaces": ("binning.py", "bin_cells_sort_meta"),
        "symbol": "bin_sort_",  # its kernels: hist, scan, place
    },
    "bin_sort.flat": {
        "source": "compute_renderer_torch/csrc/sort.cu",
        "replaces": ("binning.py", "bin_triangles_sort"),
        "symbol": "bin_sort_",
    },
}
TEXTURE_KERNELS = ("texture_tail", "texture_tail_mip", "deferred_tail",
                   "mip_rows", "vertex_stage")
# The modes of three kernels: one record each, "<kernel>.<mode>", the same
# source and TPU kernel as the base record. The front has no vis mode
# (the vis table is the base one).
MODES = ("mat", "texf")
NEW_MODES = ("vis", "texf_mip")
MODE_KERNELS = {"front_end": MODES + ("texf_mip",),
                "raster_shade_tiles": MODES + NEW_MODES,
                "raster_shade_micro": MODES + NEW_MODES}
for _name, _modes in MODE_KERNELS.items():
    for _mode in _modes:
        KERNELS[f"{_name}.{_mode}"] = KERNELS[_name]


def record(name, mode):
    """The JSON record of a kernel's mode: the base record is the kernel's
    own name."""
    return name if mode == "base" else f"{name}.{mode}"


def tpu_kernel_location(filename, function):
    """"path:line" of ``def function(`` in the JAX package's
    ``backends/<filename>`` — the TPU kernel (or the XLA-fused function)
    a CUDA kernel replaces. The port's own ``backends/`` shares some file
    names, so it is left out."""
    import glob

    port = os.path.join(ROOT, "compute_renderer_torch", "")
    for path in sorted(glob.glob(os.path.join(ROOT, "*", "backends",
                                              filename))):
        if path.startswith(port):
            continue
        with open(path) as fh:
            for n, line in enumerate(fh, 1):
                if line.startswith(f"def {function}("):
                    return f"{os.path.relpath(path, ROOT)}:{n}"
    raise SmokeFailure(f"TPU kernel {function} not found in */backends/"
                       f"{filename}")


class SmokeFailure(Exception):
    pass


def require(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def bench_scene(model="suzanne.obj", effect=None, eye=(0.0, 0.0, 3.0)):
    from compute_renderer_torch import CameraConfig, Scene, SceneConfig
    from compute_renderer_torch.core.camera import CameraMode

    config = SceneConfig(
        model_path=model, effect=effect,
        camera_config=CameraConfig(distance=2.0, mode=CameraMode.FIRST_PERSON,
                                   position=eye),
    )
    return Scene.from_config(config, W, H)


def bound_ms(nbytes, ops):
    """(least time in ms, "bytes" or "operations"): the larger of the bytes
    over the memory rate and the operations over the float32 rate."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = ops / PEAK_OPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def kernel_split_ms(fn, iters, symbol):
    """{kernel name: (device ms, launches) per call of ``fn``} of every
    kernel whose name holds ``symbol``, or of every kernel and copy it
    runs on the card when ``symbol`` is None, from torch.profiler; {} when
    the profiler records no device time."""
    import torch

    from compute_renderer_torch.bench.profiling import device_profile

    fn()
    torch.cuda.synchronize()
    try:
        with device_profile() as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
    except (RuntimeError, AssertionError) as e:  # optional here
        print(f"[time] profiler unavailable: {e!r}")
        return {}
    out = {}
    for ev in averages:
        if symbol is None:
            match = str(getattr(ev, "device_type", "")).endswith("CUDA")
        else:
            match = symbol in ev.key
        if match and ev.count:
            t = getattr(ev, "device_time_total", None)
            t = ev.cuda_time_total if t is None else t
            if t:
                out[ev.key] = (t / iters / 1e3, ev.count / iters)
    return out


def kernel_device_ms(fn, iters, symbol):
    """Device time per call of ``fn`` of every kernel whose name holds
    ``symbol`` (all its launches in a call), or of every kernel and copy
    it runs on the card when ``symbol`` is None, from torch.profiler; None
    when the profiler records no device time."""
    split = kernel_split_ms(fn, iters, symbol)
    return sum(ms for ms, _ in split.values()) or None


def mangled_names(mangled):
    """The length-prefixed identifiers of an Itanium-mangled name."""
    import re

    out, i = [], 0
    while i < len(mangled):
        m = re.match(r"\d+", mangled[i:])
        if not m:
            i += 1
            continue
        start = i + len(m.group())
        out.append(mangled[start:start + int(m.group())])
        i = start + int(m.group())
    return out


def ptxas_report(log):
    """{kernel<args>: "R registers, S/L B spill stores/loads, M B smem"}
    from nvcc's -Xptxas -v output; the args are the template arguments:
    the rasters' mode (0 base, 1 mat, 2 texf, 3 vis, 4 texf_mip), the
    texture kernels' filter (0 nearest, 1 bilinear, 2 trilinear, 3
    anisotropic) and the fused tail's packed pool (0 or 1)."""
    import re

    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            sym = next((w for w in mangled_names(m.group(1))
                        if any(k["symbol"] in w for k in KERNELS.values())
                        and not w.startswith("_GLOBAL__N")),
                       m.group(1))
            args = re.findall(r"L[ib](\d+)E", m.group(1))
            cur = f"{sym}<{','.join(args)}>" if args else sym
            out[cur] = {}
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill"] = f"{m.group(1)}/{m.group(2)} B spill"
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[cur]["stack"] = f"{m.group(1)} B stack"
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["regs"] = f"{m.group(1)} registers"
            sm = re.search(r"(\d+) bytes smem", line)
            out[cur]["smem"] = f"{sm.group(1) if sm else 0} B smem"
    return {k: ", ".join(v.get(f, "?") for f in ("regs", "spill", "stack",
                                                  "smem"))
            for k, v in out.items()}


def ulps(a, b):
    """Per-element ULP distance of two f32 tensors (same-sign lattice)."""
    import torch

    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def frame_inputs(scene, device, **tex_options):
    """The main path's per-frame tensors for the scene's next frame;
    ``tex_options`` (tex_filter, tex_mode) as the Renderer takes them."""
    import numpy as np
    import torch

    from compute_renderer_torch.backends import cuda
    from compute_renderer_torch.engine.renderer import Renderer, unpack_uniforms

    packed, L = Renderer.pack_uniforms(scene.update(DT))
    vpos, vp, eff, lwp, lc, li = unpack_uniforms(
        torch.from_numpy(packed).to(device), L)
    mesh = scene.mesh
    pos = torch.as_tensor(mesh.positions, device=device)
    nrm = torch.as_tensor(mesh.normals, device=device)
    tri = torch.as_tensor(mesh.indices.astype(np.int32),
                          device=device).reshape(-1, 3)
    return {
        "pos_soa": cuda.corner_soa(pos, tri), "nrm_soa": cuda.corner_soa(
            nrm, tri), "vp": vp, "vpos": vpos, "eff": eff, "lwp": lwp,
        "lc": lc, "li": li, "T": int(tri.shape[0]), "positions": pos,
        "normals": nrm, "tri": tri,
        # The mesh's kd / texture inputs, as the renderer uploads them.
        "ext": cuda.mesh_ext_tensors(mesh, tri, device, **tex_options),
    }


def front_modes(x, mode):
    """The front end's mode inputs as the engine builds them: none (base,
    vis), kd rows (mat), kd, uv corners and TextureInfo rows (texf), or
    kd, uv corners and the frame's mip rows (texf_mip)."""
    from compute_renderer_torch.backends import cuda

    e = x["ext"]
    _, kw = cuda._frame_texture(
        mode, x["positions"], x["tri"], x["vp"], x["eff"], W, H,
        e.get("face_kd"), e.get("uvs"), e.get("uv_soa"), e.get("tex_rows"),
        e.get("face_tex"), e.get("tex_mips"), e.get("tex_filter"))
    return kw


def gbuffer_mode(mode):
    return mode in ("texf", "texf_mip")


def compare_outputs(tag, mode, out_k, key_k, out_p, key_p):
    """A raster kernel's outputs against its twin's: keys bitwise; RGBA
    within 1 LSB, vis ids (triangle or pair) bitwise, or in the texf modes
    the G-buffer's planes bitwise where the key is set (undefined
    elsewhere, ``raster.defined_planes``; the max ULP per channel is
    printed if not). Returns (max abs error, covered pixels)."""
    import torch

    from compute_renderer_torch.backends import raster

    kk = key_k.view(torch.int32)
    require(torch.equal(kk, key_p.view(torch.int32)),
            f"{tag}: depth keys differ from the twin")
    covered = kk != -1
    if mode == "vis":
        require(out_k.dtype == torch.int32 and torch.equal(out_k, out_p),
                f"{tag}: vis ids differ from the twin")
        return 0.0, int(covered.sum())
    if not gbuffer_mode(mode):
        bk = raster.unpack_rgba(out_k.view(torch.uint32)).to(torch.int32)
        bp = raster.unpack_rgba(out_p.view(torch.uint32)).to(torch.int32)
        diff = int((bk - bp).abs().max())
        require(diff <= 1, f"{tag}: RGBA differs by {diff}")
        return float(diff), int(covered.sum())
    out_k = raster.defined_planes(out_k, key_k)
    out_p = raster.defined_planes(out_p, key_p)
    if not torch.equal(out_k.view(torch.int32), out_p.view(torch.int32)):
        per_channel = [int(ulps(a, b).max()) for a, b in zip(out_k, out_p)]
        raise SmokeFailure(f"{tag}: G-buffer differs from the twin: max ULP "
                           f"per channel {per_channel}")
    return 0.0, int(covered.sum())


def check_front(name, x, wave, report, tile=(16, 256), mode="base"):
    """Front kernel vs twin on one frame's inputs, in ``mode``: the (T, R)
    tables (``[:, :R]``, the pad column aside) and meta; the kernel's table
    in the layout the rasters take without a copy. Returns (table,
    meta)."""
    import torch

    from compute_renderer_torch.backends import front, raster

    kw = dict(width=W, height=H, tile_h=tile[0], tile_w=tile[1],
              **front_modes(x, mode))
    args = (x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"])
    ck, mk = front.front_end(*args, **kw)  # the public wrapper's card route
    cp, mp = front.front_end_plain(*args, **kw)
    torch.cuda.synchronize()
    R = raster.MODE_WIDTHS[mode]
    stride = raster.table_stride(R)
    require(ck.shape == (x["T"], R) and ck.stride() == (stride, 1)
            and ck.data_ptr() % 16 == 0,
            f"front {name}: table {tuple(ck.shape)} at strides "
            f"{ck.stride()}, not the rasters' ({x['T']}, {R}) at "
            f"({stride}, 1), 16-byte aligned")
    copies = raster.kernel_table.copies
    require(raster.kernel_table(ck)[0].data_ptr() == ck.data_ptr()
            and raster.kernel_table.copies == copies,
            f"front {name}: the rasters would copy the front's table")
    require(torch.equal(mk, mp), f"front {name}: meta differs from the twin")
    nan_k, nan_p = torch.isnan(ck), torch.isnan(cp)
    require(torch.equal(nan_k, nan_p),
            f"front {name}: NaN positions differ from the twin")
    keep = ~nan_k
    worst_ulp = int(ulps(ck[keep], cp[keep]).max()) if keep.any() else 0
    # Equal values (infinities included) count as 0, not inf - inf.
    gap = torch.where(ck == cp, torch.zeros_like(ck), (ck - cp).abs())
    max_abs = float(gap[keep].max()) if keep.any() else 0.0
    limit = 1 if wave else 0
    require(worst_ulp <= limit,
            f"front {name}: coeff differs by {worst_ulp} ULP (limit {limit})")
    print(f"[check] front {name} {mode} {tile[0]}x{tile[1]}: table "
          f"{tuple(ck.shape)} row stride {stride} (the rasters' own, no "
          f"copy), meta bitwise, table worst {worst_ulp} ULP (limit "
          f"{limit}), max abs {max_abs:g}")
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), max_abs)
    return ck, mk


def check_raster(name, x, table, meta, caps, report, mode="base",
                 outputs=None):
    """Raster kernel vs twin on one frame, both layouts, in ``mode``, at
    each tile shape of ``cuda.TILE_CANDIDATES`` (the front's table and
    ``meta`` are the 16x256 ones; the other shapes run the front again),
    the flat layout over its bin sort's span list; returns each (tile,
    layout)'s inputs for the timing runs, and puts each layout's kernel
    outputs (out, key) at 16x256 in ``outputs``."""
    import torch

    from compute_renderer_torch.backends import binning, cuda, front, raster

    params, lights = raster.shading_inputs(x["eff"], x["vpos"], x["lwp"],
                                           x["lc"], x["li"])
    fmode = "base" if mode == "vis" else mode
    inputs = {}
    for tile in cuda.TILE_CANDIDATES:
        th, tw = tile
        if tile != (16, 256):
            table, meta = front.front_end(
                x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"], width=W,
                height=H, tile_h=th, tile_w=tw, **front_modes(x, fmode))
        ntx, nty = (W + tw - 1) // tw, (H + th - 1) // th
        setup = binning.setup_from_meta(meta)
        # Caps grown to this tile shape's exact need, so both layouts fit.
        need = binning.exact_tile_counts(setup, ntx, nty)
        tcaps = dict(caps, tile_cap=max(caps["tile_cap"], int(need.max())),
                     pair_cap=max(caps["pair_cap"], int(need.sum())))
        kw = dict(height_padded=nty * th, width_padded=ntx * tw, tile_h=th,
                  tile_w=tw)
        for layout, binner in (("dense", binning.bin_triangles_dense),
                               ("flat", binning.bin_triangles_sort)):
            bins = binner(setup, ntx, nty, tcaps["pair_cap"],
                          tcaps["tile_cap"])
            flags = torch.stack([bins["pair_needed"], bins["tile_needed"]])
            require(not bool(flags.any()), f"raster {name} {th}x{tw} "
                    f"{layout}: overflow {flags.tolist()} at caps {tcaps}")
            data = bins["bin_rows"] if layout == "dense" else bins["pair_tri"]
            # The public wrapper's card route (on-device shading inputs,
            # u32 outputs, the bin sort's span list) against the twin on
            # the same inputs.
            rk, kk = raster.raster_shade_tiles(
                table, data, bins["seg_start"], bins["seg_count"], x["eff"],
                x["vpos"], x["lwp"], x["lc"], x["li"], layout=layout,
                mode=mode, spans=bins.get("spans"), **kw)
            rp, kp = raster.raster_shade_tiles_plain(
                table, data, bins["seg_start"], bins["seg_count"], params,
                lights, layout=layout, mode=mode, **kw)
            torch.cuda.synchronize()
            diff, covered = compare_outputs(
                f"raster {name} {mode} {th}x{tw} {layout}", mode, rk, kk, rp,
                kp)
            what = mode_check_text(mode, diff)
            spans = (f", spans past the first {int(bins['spans'][0])}"
                     if layout == "flat" else "")
            print(f"[check] raster {name} {mode} {th}x{tw} {layout}: keys "
                  f"bitwise, {what}, covered {covered}, pairs "
                  f"{int(bins['total_pairs'])}, occupied tiles "
                  f"{int((bins['seg_count'] > 0).sum())}, longest list "
                  f"{int(bins['seg_count'].max())}{spans}")
            report["max_abs_err"] = max(report.get("max_abs_err", 0.0), diff)
            inputs[tile, layout] = (table, data, bins, params, lights, kw,
                                    layout)
            if outputs is not None and tile == (16, 256):
                outputs[layout] = (rk, kk)
    return inputs


def tile_walk(tag, table, data, bins, params, lights, rkw):
    """Prints what the tile raster walks on these bins: the longest list,
    the cull's survivors and the samples walked, beside the unculled
    walk's (the kernel's decomposition, raster.raster_shade_subtiles_plain,
    run on the card tensors)."""
    from compute_renderer_torch.backends import raster

    stats = {}
    raster.raster_shade_subtiles_plain(
        table[:, :raster.TRI_TABLE_WIDTH], data, bins["seg_start"],
        bins["seg_count"], params, lights, layout=bins["layout"],
        mode="vis", stats=stats, **rkw)
    sub_h, sub_w = raster.sub_shape(rkw["tile_h"])
    print(f"[walk] {tag}: longest list {int(bins['seg_count'].max())} of "
          f"{stats['pairs']} pairs; survivors {stats['sub_survivors']} "
          f"(pair, {sub_h}x{sub_w} block), "
          f"{stats['patch_survivors']} (pair, 8x8 warp patch); "
          f"{stats['spans']} spans past the tiles' first; samples "
          f"walked {stats['samples_walked']}, unculled "
          f"{stats['samples_unculled']}")


def micro_walk(tag, table, bins, params, lights, mkw):
    """Prints what the micro raster walks on these bins: the densest cell,
    the cells over SPAN pairs and their spans, the span warps launched,
    the cull's kept (pair, quad) items, the pairs walked whole and the
    samples tested, beside the 64 a pair of the walk without the cull (the
    kernel's decomposition, micro.raster_shade_micro_culled_plain, run on
    the card tensors)."""
    from compute_renderer_torch.backends import micro

    counts = bins["seg_count"].long()
    starts = bins["seg_start"].long()
    span = micro.SPAN
    long_cell = counts > span
    spans = ((starts + counts - 1) // span - starts // span + 1)[long_cell]
    stats = {}
    micro.raster_shade_micro_culled_plain(
        table[:, :32], bins["pair_tri"], bins["seg_start"],
        bins["seg_count"], params, lights, mode="vis", stats=stats, **mkw)
    print(f"[walk] {tag}: densest cell {int(counts.max())} pairs; "
          f"{int(long_cell.sum())} cells over {span} pairs hold "
          f"{int(counts[long_cell].sum())} of {int(counts.sum())} pairs in "
          f"{int(spans.sum())} spans; "
          f"{-(-bins['pair_tri'].shape[0] // span)} span warps launched; "
          f"cull keeps {stats['items']} (pair, 2x2 quad) items "
          f"({stats['items'] / max(stats['pairs'], 1):.3f} a pair), "
          f"{stats['wide']} pairs walked whole (> {micro.WIDE} quads); "
          f"samples tested {stats['samples']}, unculled "
          f"{stats['pairs'] * 64}")


# The binning kernel's bound: per triangle its 16 meta bytes, per tile its
# row of C ids and 12 bytes of seg_start, seg_count and the work list; one
# operation a listed pair (its slot), one a tile (the scan).
BIN_META_BYTES = 16
BIN_TILE_BYTES = 12


def check_bins(tag, meta, ntx, nty, tile_cap, report, direct=False):
    """``bin_tiles_dense`` against its twin (``binning.bin_tiles_meta_plain``
    on the same card tensors, the dense layout) on one meta: every output
    bitwise, bin_rows whole. The kernel is reached through the public
    wrapper, or called directly (``direct``) where the dense rule would
    send the frame to the flat layout. Returns the kernel's bins."""
    import torch

    from compute_renderer_torch.backends import binning
    from tests.torch_bin_cases import BIN_KEYS

    if direct:
        got = binning._bin_tiles_cuda(meta, ntx, nty, tile_cap)
        want = binning._with_worklist(binning.bin_triangles_dense(
            binning.setup_from_meta(meta), ntx, nty, 0, tile_cap))
    else:
        launches = launch_count("bin_tiles_meta")
        got = binning.bin_tiles_meta(meta, ntx, nty, 0, tile_cap)
        require(got["layout"] == "dense"
                and launch_count("bin_tiles_meta") == launches + 1,
                f"bins {tag}: the wrapper did not launch the kernel")
        want = binning.bin_tiles_meta_plain(meta, ntx, nty, 0, tile_cap)
    torch.cuda.synchronize()
    for key in BIN_KEYS:
        a, b = got[key], want[key]
        require(a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b),
                f"bins {tag}: {key} differs from the twin")
    counts = want["seg_count"]
    print(f"[check] bin_tiles_dense {tag}: {ntx}x{nty} tiles, C "
          f"{got['bin_rows'].shape[1]}, T {meta.shape[1]}: bin_rows, "
          f"segments, work list (k {int(got['k'])}), total "
          f"{int(got['total_pairs'])} and overflow "
          f"{got['overflow'].tolist()} bitwise; longest list "
          f"{int(counts.max()) if counts.numel() else 0}")
    report["max_abs_err"] = 0.0  # every output bitwise
    return got


def check_shading(tag, args, y_offset, report):
    """``shading_params`` against its twin on card tensors, bitwise:
    ``args`` = (effect, view_position, light pos, color, intensity), as
    the caller's path holds them (the main path's are views into the
    uploaded uniform buffer)."""
    import torch

    from compute_renderer_torch.backends import raster

    pk, lk = raster.shading_inputs(*args, y_offset)
    pp, lp = raster.shading_inputs_plain(*args, y_offset)
    torch.cuda.synchronize()
    require(torch.equal(pk.view(torch.int32), pp.view(torch.int32))
            and torch.equal(lk.view(torch.int32), lp.view(torch.int32)),
            f"shading_params {tag}: differs from the twin (kernel "
            f"{pk.tolist()}, twin {pp.tolist()})")
    print(f"[check] shading_params {tag} y_offset {y_offset}: params and "
          f"{lk.shape[0]} light rows bitwise; melt threshold "
          f"{float(pk[1])!r}")
    report["max_abs_err"] = 0.0


def phase_bins(device, reports):
    """Phase 3's binning and shading kernels: ``bin_tiles_dense`` on the
    synthetic cases of tests/test_torch_tile_bins.py and on Suzanne's meta
    at both tuner tile shapes (whole and a chunk view), ``shading_params``
    in the four effects; then both timed at the main path's shapes."""
    import types

    import torch

    from compute_renderer_torch.backends import binning, cuda, front, raster
    from compute_renderer_torch.bench.profiling import event_ms
    from compute_renderer_torch.core import effects
    from tests.torch_bin_cases import META_CASES, meta_case, shading_case

    rep_b = reports["bin_tiles_dense"]
    for case in META_CASES:
        meta, ntx, nty, tile_cap, cut = meta_case(case)
        m = torch.from_numpy(meta).to(device)
        if cut is not None:
            m = m[:, cut[0]:cut[1]]
        check_bins(case, m, ntx, nty, tile_cap, rep_b)
    x = frame_inputs(bench_scene(), device)
    args = (x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"])
    main = None
    for th, tw in cuda.TILE_CANDIDATES:
        _, meta = front._front_end_cuda(*args, width=W, height=H, tile_h=th,
                                        tile_w=tw)
        ntx, nty = -(-W // tw), -(-H // th)
        tc = cuda.default_caps("tile", x["T"], W, H, th, tw)["tile_cap"]
        bins = check_bins(f"suzanne {th}x{tw}", meta, ntx, nty, tc, rep_b)
        require(not bool(bins["overflow"].any()),
                f"bins suzanne {th}x{tw}: overflow at the default cap")
        check_bins(f"suzanne {th}x{tw} chunk [300, 1000)",
                   meta[:, 300:1000], ntx, nty, tc, rep_b)
        if (th, tw) == cuda.choose_tile(x["T"], W, H):
            main = (meta, ntx, nty, tc, bins)

    rep_s = reports["shading_params"]
    ns = types.SimpleNamespace(effects=effects)
    for effect in ("none", "voxelize", "edge_melt", "mirage"):
        sargs = [torch.from_numpy(a).to(device)
                 for a in shading_case(ns, effect)]
        for y_offset in (0, 96):
            check_shading(effect, sargs, y_offset, rep_s)
    # The main path's own inputs: bench.py's frame (two lights, views into
    # the packed uniforms), at row 0 and at stripe 1 of 2 (16-row tiles).
    for y_offset in (0, SHADING_STRIPE_ROWS["tile"]):
        check_shading("suzanne main path", [x[k] for k in SHADING_KEYS],
                      y_offset, rep_s)

    # Times at the main path's shapes: Suzanne 1024x768 at 16x256.
    meta, ntx, nty, tc, bins = main
    C = bins["bin_rows"].shape[1]
    rep_b["ms"] = kernel_device_ms(
        lambda: binning._bin_tiles_cuda(meta, ntx, nty, tc), 50,
        KERNELS["bin_tiles_dense"]["symbol"])
    rep_b["ms_events"] = event_ms(
        lambda: binning._bin_tiles_cuda(meta, ntx, nty, tc), 200)
    rep_b["plain_ms"] = event_ms(
        lambda: binning.bin_tiles_meta_plain(meta, ntx, nty, 0, tc), 50)
    rep_b["library_ms"] = None  # no PyTorch call bins triangles to tiles
    rep_b["bound_ms"], rep_b["bound_by"] = bound_ms(
        meta.shape[1] * BIN_META_BYTES + ntx * nty * (4 * C + BIN_TILE_BYTES)
        + 16, int(bins["total_pairs"]) + ntx * nty)
    sargs = (x["eff"], x["vpos"], x["lwp"], x["lc"], x["li"], 0)
    L = x["lwp"].shape[0]
    rep_s["ms"] = kernel_device_ms(lambda: raster._shading_cuda(*sargs), 50,
                                   KERNELS["shading_params"]["symbol"])
    rep_s["ms_events"] = event_ms(lambda: raster._shading_cuda(*sargs), 200)
    rep_s["plain_ms"] = event_ms(lambda: raster.shading_inputs_plain(*sargs),
                                 50)
    rep_s["library_ms"] = None  # no PyTorch call builds these rows
    # 6 effect, 3 eye and 7 floats a light in; 11 params and 8 a light
    # out; about 20 operations (sinf counted as 10).
    rep_s["bound_ms"], rep_s["bound_by"] = bound_ms(
        4 * (6 + 3 + 7 * L) + 4 * (11 + 8 * L), 20)
    for name in ("bin_tiles_dense", "shading_params"):
        print_time(name, reports[name])


# The shading inputs of frame_inputs(), in shading_inputs' order, and the
# row offset of a stripe the sharded renders give it: stripe 1 of 2 at
# 16-row tiles (768 rows), stripe 1 of 4 at 8-row cells.
SHADING_KEYS = ("eff", "vpos", "lwp", "lc", "li")
SHADING_STRIPE_ROWS = {"tile": 384, "micro": 192}


def check_bins_structured(device, reports, scenes):
    """Phase 3's last binning case, once the structured scenes are loaded:
    the kernel called directly on structured_scene_tex's meta (36,322
    triangles; the dense rule sends this frame to the flat layout, and its
    heaviest tiles overflow the default C) against the dense twin."""
    from compute_renderer_torch.backends import binning, cuda, front

    x = frame_inputs(scene_copy(scenes["structured_tex+textures"]), device)
    th, tw = cuda.choose_tile(x["T"], W, H)
    _, meta = front._front_end_cuda(x["pos_soa"], x["nrm_soa"], x["vp"],
                                    x["eff"], width=W, height=H, tile_h=th,
                                    tile_w=tw)
    ntx, nty = -(-W // tw), -(-H // th)
    tc = cuda.default_caps("tile", x["T"], W, H, th, tw)["tile_cap"]
    bins = check_bins(f"structured_tex {th}x{tw} (direct)", meta, ntx, nty,
                      tc, reports["bin_tiles_dense"], direct=True)
    layout = "dense" if binning.dense_layout(ntx, nty, tc, x["T"]) else "flat"
    print(f"[check] bin_tiles_dense structured_tex: the dense rule picks "
          f"{layout}; tile_needed {int(bins['tile_needed'])} at C "
          f"{bins['bin_rows'].shape[1]}")


# The bin sort's bound: the bytes the function must move, whatever the
# design. Each valid slot's bin and triangle in (8 B) and its triangle out
# (4 B); each bin's segment start and count out (8 B); each tile's
# work-list entry (4 B; the micro layout also its tile count and window
# base, 12 B); the total in, scal out. Under pair overflow of the flat
# layout also each triangle's rect (16 B of meta) for the exact counts.
# Integer work of a few operations a slot, far below the bytes' time. The
# vertex stage: a vertex's 12 B in and 28 B out, about 40 operations
# (three 4-term rows and the divides; a wave frame's sinf not counted).
SORT_SLOT_BYTES = 12
SORT_BIN_BYTES = 8
SORT_TILE_BYTES = {"micro": 12, "flat": 4}
SORT_RECT_BYTES = 16
VERTEX_BYTES = 12 + 28
VERTEX_OPS = 40
# The stress segment: pairs on one bin, across several of the kernel's
# chunks (binning.SORT_CHUNK).
SORT_STRESS = 20_000
# The bin sort's kernels a call (csrc/sort.cu): count, scan, place.
SORT_LAUNCHES = 3


def sort_bound(keys, total, num_bins, layout, T=0):
    """(bound ms, "bytes") of the bin sort on this pair list: its
    compulsory bytes; ``T`` the flat layout's triangles, whose rects are
    read under pair overflow."""
    n = min(int(total), keys.shape[0])
    tiles = num_bins // (16 if layout == "micro" else 1)
    over = int(total) > keys.shape[0]
    nbytes = (n * SORT_SLOT_BYTES + num_bins * SORT_BIN_BYTES
              + tiles * SORT_TILE_BYTES[layout] + 4 + 16
              + (T * SORT_RECT_BYTES if over else 0))
    return bound_ms(nbytes, 0)


def compare_bins(tag, got, want, n):
    """Two bin dicts equal: ``pair_tri`` bitwise on [0, n), every other
    output bitwise."""
    import torch

    keys = set(want) - {"layout"}
    require(keys == set(got) - {"layout"},
            f"{tag}: outputs {sorted(set(got) ^ set(want))} differ")
    for key in sorted(keys):
        a, b = got[key], want[key]
        if key == "pair_tri":
            a, b = a[:n], b[:n]
        require(a.dtype == b.dtype and a.shape == b.shape
                and torch.equal(a, b), f"{tag}: {key} differs from the twin")


def check_bin_sort(tag, keys, tris, total, num_bins, report, **kw):
    """``bin_sort``'s kernel against its twin (``bin_sort_plain``, with the
    flat layout's exact counts) on the same card tensors: ``pair_tri``
    bitwise on the valid prefix, every other output bitwise. Returns the
    kernel's bins."""
    import torch

    from compute_renderer_torch.backends import binning

    before = launch_count("bin_sort")
    got = binning.bin_sort(keys, tris, total, num_bins, **kw)
    require(launch_count("bin_sort") == before + 1,
            f"bin_sort {tag}: the wrapper did not launch the kernel")
    exact = None
    if kw.get("meta") is not None:
        exact = binning.exact_tile_counts(
            binning.setup_from_meta(kw["meta"]), kw["ntx"],
            num_bins // kw["ntx"])
    want = binning.bin_sort_plain(keys, tris, total, num_bins,
                                  group=kw.get("group", 1),
                                  cap=kw.get("cap", binning.CAP_NONE),
                                  exact=exact)
    torch.cuda.synchronize()
    n = min(int(total), keys.shape[0])
    compare_bins(f"bin_sort {tag}", got, want, n)
    counts = torch.bincount(keys[:n].long(), minlength=num_bins)
    print(f"[check] bin_sort {tag}: {num_bins} bins, {n} of "
          f"{keys.shape[0]} slots, total {int(total)}: pair_tri, segments, "
          f"work list (k {int(got['k'])}) and overflow "
          f"{got['overflow'].tolist()} bitwise; longest segment "
          f"{int(counts.max()) if counts.numel() else 0}, "
          f"{int((counts > 0).sum())} bins occupied, "
          f"{-(-n // binning.SORT_CHUNK)} chunks of {binning.SORT_CHUNK}")
    report["max_abs_err"] = 0.0  # every output bitwise
    return got


def check_flat_bins(tag, meta, ntx, nty, pair_cap, tile_cap, report):
    """The flat layout's card path (the expansion in row-major tile ids,
    then the bin sort) against its twin (``bin_triangles_sort`` and the
    work list) on the same meta, every output bitwise (``pair_tri`` on
    its valid prefix), and the bin sort alone on the kernel's pairs."""
    import torch

    from compute_renderer_torch.backends import binning, expand

    got = binning._bin_tiles_flat_cuda(meta, ntx, nty, pair_cap, tile_cap)
    want = binning._with_worklist(binning.bin_triangles_sort(
        binning.setup_from_meta(meta), ntx, nty, pair_cap, tile_cap))
    torch.cuda.synchronize()
    n = min(int(want["total_pairs"]), pair_cap)
    compare_bins(f"flat bins {tag}", got, want, n)
    keys, tris, total = expand._expand_cuda(
        meta[3], meta[2], meta[0], meta[1], pair_cap=pair_cap, ntx_t=0,
        num_cells=ntx * nty, row_width=ntx)
    check_bin_sort(f"flat {tag}", keys, tris, total, ntx * nty, report,
                   cap=tile_cap, meta=meta, ntx=ntx)
    print(f"[check] flat bins {tag}: {ntx}x{nty} tiles, pair_cap "
          f"{pair_cap}, tile_cap {tile_cap}: equal to bin_triangles_sort "
          f"(longest list {int(want['seg_count'].max())}, overflow "
          f"{got['overflow'].tolist()})")
    return keys, tris, total


def extreme_sort_lists(device):
    """Two extremes of the key distribution, at the frame's cells (16 a
    tile) and at the flat layout's 192 tiles: 100,000 pairs all in one
    bin, and every pair in a bin of its own; the num_bins sentinel past
    the total. Yields (tag, keys, tris, total, num_bins, group)."""
    import torch

    num_cells = ((W + 127) // 128) * ((H + 7) // 8) * 16
    for num_bins, group in ((num_cells, 16), (192, 1)):
        for label, n in (("one bin", 100_000), ("distinct bins", num_bins)):
            pair_cap = n + 4096
            keys = torch.full((pair_cap,), num_bins, dtype=torch.int32,
                              device=device)
            keys[:n] = (num_bins // 3 if label == "one bin"
                        else torch.arange(n, dtype=torch.int32,
                                          device=device))
            tris = torch.arange(pair_cap, dtype=torch.int32,
                                device=device) * 3
            yield (f"{label} ({num_bins} bins, group {group})", keys, tris,
                   torch.full((), n, dtype=torch.int32, device=device),
                   num_bins, group)


def phase_sort_kernels(device, reports, scenes):
    """The bin sort (csrc/sort.cu) and the vertex stage
    (csrc/texture.cu vertex_stage_kernel) against their twins on the
    card, bitwise: the cases of tests/test_torch_bin_sort.py and the
    stress segment of SORT_STRESS pairs on both layouts, the lists of
    ``extreme_sort_lists``; the micro layout
    on structured_scene.obj within and past its pair capacity; the flat
    layout on structured_scene_tex.obj and san_miguel_small at both tuner
    tile shapes, at the default caps (structured_tex's heaviest tiles
    overflow C), at the frame's exact need and at half its pairs; the
    vertex stage on structured +deferred trilinear's frame and on a wave
    frame; then the vertex stage's and the flat sort's times at the main
    rows' shapes (the micro sort's are phase 4's)."""
    import torch

    from compute_renderer_torch.backends import (
        binning, common, cuda, expand, front, texture,
    )
    from compute_renderer_torch.bench.profiling import event_ms
    from compute_renderer_torch.core.effects import Effect, WaveDirection
    from tests.torch_bin_cases import (
        LONG, MICRO_SORT_CASES, SORT_CASES, sort_case, sort_pairs,
    )

    def on(a):
        return torch.from_numpy(a).to(device)

    for layout, names in (("micro", MICRO_SORT_CASES),
                          ("flat", SORT_CASES)):
        rec = "bin_sort" if layout == "micro" else "bin_sort.flat"
        for name in names:
            for long in ((LONG, SORT_STRESS) if name == "long" else (LONG,)):
                meta, ntx, nty, pair_cap, cap = sort_case(layout, name,
                                                          long=long)
                keys, tris, total = sort_pairs(meta, ntx, ntx * nty,
                                               pair_cap)
                kw = (dict(group=16) if layout == "micro"
                      else dict(cap=cap, meta=on(meta), ntx=ntx))
                check_bin_sort(
                    f"{layout} {name}{f' {long}' if name == 'long' else ''}",
                    on(keys), on(tris),
                    torch.full((), total, dtype=torch.int32, device=device),
                    ntx * nty, reports[rec], **kw)

    for tag, keys, tris, total, num_bins, group in extreme_sort_lists(
            device):
        check_bin_sort(tag, keys, tris, total, num_bins, reports["bin_sort"],
                       group=group)

    ntx_t, nty_t = (W + 127) // 128, (H + 7) // 8
    num_cells = ntx_t * nty_t * 16
    x = frame_inputs(scene_copy(scenes["structured+textures"]), device)
    _, meta = front._front_end_cuda(x["pos_soa"], x["nrm_soa"], x["vp"],
                                    x["eff"], width=W, height=H, tile_h=8,
                                    tile_w=8)
    total = int(meta[3].sum())
    for pair_cap in (cuda.grow_pair_cap(0, max(total, num_cells, 1024)),
                     total // 2):
        keys, tris, tot = expand.expand_cells(
            meta[3], meta[2], meta[0], meta[1], pair_cap=pair_cap,
            ntx_t=ntx_t, num_cells=num_cells)
        check_bin_sort(f"micro structured pair_cap {pair_cap}", keys, tris,
                       tot, num_cells, reports["bin_sort"], group=16)

    timing = None
    for tag, scene in (
            ("structured_tex", scene_copy(scenes["structured_tex+textures"])),
            ("san_miguel_small", bench_scene("san_miguel_small.obj"))):
        x = frame_inputs(scene, device)
        for th, tw in cuda.TILE_CANDIDATES:
            _, meta = front._front_end_cuda(
                x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"], width=W,
                height=H, tile_h=th, tile_w=tw)
            ntx, nty = -(-W // tw), -(-H // th)
            caps = cuda.default_caps("tile", x["T"], W, H, th, tw)
            require(not binning.dense_layout(ntx, nty, caps["tile_cap"],
                                             x["T"]),
                    f"{tag} {th}x{tw}: the dense rule picks the dense layout")
            need = binning.exact_tile_counts(binning.setup_from_meta(meta),
                                             ntx, nty)
            fit = (int(need.sum()), max(caps["tile_cap"], int(need.max())))
            for label, pc, tc in (
                    ("default caps", caps["pair_cap"], caps["tile_cap"]),
                    ("exact need", *fit),
                    ("half the pairs", fit[0] // 2, fit[1])):
                pairs = check_flat_bins(f"{tag} {th}x{tw} {label}", meta,
                                        ntx, nty, pc, tc,
                                        reports["bin_sort.flat"])
                if (tag, (th, tw), label) == ("structured_tex", (16, 256),
                                              "exact need"):
                    timing = (meta, ntx, nty, tc, pairs)

    rep_v = reports["vertex_stage"]
    for tag, effect in (("structured +deferred trilinear", None),
                        ("structured +deferred trilinear, wave",
                         Effect.wave(0.4, 3.0, 2.0, WaveDirection.VERTICAL))):
        scene = scene_copy(scenes["structured+textures"],
                           texture_filter="trilinear")
        if effect is not None:
            scene = scene_copy(scene, effect=effect)
        x = frame_inputs(scene, device)
        args = (x["positions"], x["vp"], x["eff"], W, H)
        before = launch_count("vertex_stage")
        wk, sk = texture.vertex_stage(*args)
        wp, sp = common.vertex_stage(*args)
        torch.cuda.synchronize()
        require(launch_count("vertex_stage") == before + 1,
                f"vertex_stage {tag}: the wrapper did not launch its kernel")
        i32 = torch.int32
        require(torch.equal(wk.view(i32), wp.view(i32))
                and torch.equal(sk.view(i32), sp.view(i32)),
                f"vertex_stage {tag}: differs from common.vertex_stage "
                f"(world {int(ulps(wk, wp).max())} ULP, screen "
                f"{int(ulps(sk, sp).max())} ULP)")
        print(f"[check] vertex_stage {tag}: N={wk.shape[0]}, world and "
              f"screen bitwise (NaN in screen: "
              f"{int(torch.isnan(sk).any(1).sum())} rows)")
        rep_v["max_abs_err"] = 0.0

    # Times: the vertex stage over structured_scene.obj's vertices.
    N = x["positions"].shape[0]
    args = (x["positions"], x["vp"], x["eff"], W, H)
    rep_v["ms"] = kernel_device_ms(lambda: texture.vertex_stage(*args), 50,
                                   KERNELS["vertex_stage"]["symbol"])
    rep_v["ms_events"] = event_ms(lambda: texture.vertex_stage(*args), 200)
    rep_v["plain_ms"] = event_ms(lambda: common.vertex_stage(*args), 20)
    rep_v["library_ms"] = None  # no PyTorch call computes this stage
    rep_v["bound_ms"], rep_v["bound_by"] = bound_ms(N * VERTEX_BYTES,
                                                    N * VERTEX_OPS)
    print_time("vertex_stage", rep_v, f"structured, N={N}")

    # The flat sort at structured_tex 16x256, capacities at the frame's
    # need: the kernel, its twin (the exact counts included) and torch's
    # stable sort with the gather and the two searchsorted it replaces.
    meta, ntx, nty, tc, (keys, tris, total) = timing
    num_tiles = ntx * nty
    rep_f = reports["bin_sort.flat"]
    run = lambda: binning._bin_sort_cuda(keys, tris, total, num_tiles, 1,  # noqa: E731
                                         tc, meta, ntx)
    rep_f["ms"] = kernel_device_ms(run, 50, KERNELS["bin_sort"]["symbol"])
    rep_f["ms_events"] = event_ms(run, 200)

    def plain():
        exact = binning.exact_tile_counts(binning.setup_from_meta(meta), ntx,
                                          nty)
        return binning.bin_sort_plain(keys, tris, total, num_tiles, cap=tc,
                                      exact=exact)

    rep_f["plain_ms"] = event_ms(plain, 20)
    ids = torch.arange(num_tiles, dtype=torch.int32, device=device)

    def library():
        skeys, order = torch.sort(keys, stable=True)
        return (tris[order],
                torch.searchsorted(skeys, ids, side="left", out_int32=True),
                torch.searchsorted(skeys, ids, side="right", out_int32=True))

    rep_f["library_ms"] = kernel_device_ms(library, 50, None)
    if rep_f["library_ms"] is None:
        rep_f["library_ms"] = event_ms(library, 50)
    rep_f["bound_ms"], rep_f["bound_by"] = sort_bound(
        keys, total, num_tiles, "flat", meta.shape[1])
    print_time("bin_sort.flat", rep_f, f"structured_tex 16x256, "
               f"{int(total)} pairs, tile_cap {tc}")
    print(f"[time] bin_sort.flat (structured_tex): torch.sort(stable) + "
          f"gather + 2 searchsorted {rep_f['library_ms']} ms (device time "
          f"of all their launches)")
    print_sort_split(f"flat structured_tex 16x256, {int(total)} pairs",
                     run)


def print_sort_split(tag, run):
    """Each bin_sort_* kernel's device time a call of ``run``, printed."""
    split = kernel_split_ms(run, 50, KERNELS["bin_sort"]["symbol"])
    print(f"[sort] {tag}: " + "; ".join(
        f"{short_name(name)} {ms:.6f} ms x{count:g}"
        for name, (ms, count) in sorted(split.items(),
                                        key=lambda kv: -kv[1][0])))


def short_name(kernel):
    """A kernel's name without its namespace and parameters."""
    return kernel.replace("(anonymous namespace)::", "").split("(")[0]


def phase_kernels(device, reports):
    from compute_renderer_torch.backends import binning, cuda, front, raster
    from compute_renderer_torch.bench.profiling import event_ms
    from compute_renderer_torch.core.effects import Effect, WaveDirection

    cases = (
        ("suzanne", "suzanne.obj", None),
        ("san_miguel_small", "san_miguel_small.obj", None),
        ("suzanne+wave", "suzanne.obj",
         Effect.wave(0.4, 3.0, 2.0, WaveDirection.VERTICAL)),
    )
    timing = {}
    for name, model, effect in cases:
        scene = bench_scene(model, effect)
        for _ in range(3):  # advance the animation a few frames
            scene.update(DT)
        x = frame_inputs(scene, device)
        table, meta = check_front(name, x, effect is not None,
                                  reports["front_end"])
        # check_raster sizes the caps to each tile shape's exact need, as
        # the engine's retry would, so that both layouts fit.
        caps = cuda.default_caps("tile", x["T"], W, H)
        for (tile, layout), args in check_raster(
                name, x, table, meta, caps,
                reports["raster_shade_tiles"]).items():
            if tile == (16, 256):
                timing[f"{name}/{layout}"] = (x, args)

    # Times at the main path's shapes: Suzanne 1024x768, dense layout.
    scene = bench_scene()
    x = frame_inputs(scene, device)
    args = (x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"])
    kw = dict(width=W, height=H, tile_h=16, tile_w=256)
    rep = reports["front_end"]
    rep["ms"] = kernel_device_ms(lambda: front._front_end_cuda(*args, **kw),
                                 50, KERNELS["front_end"]["symbol"])
    rep["ms_events"] = event_ms(lambda: front._front_end_cuda(*args, **kw),
                                200)
    rep["plain_ms"] = event_ms(lambda: front.front_end_plain(*args, **kw), 20)
    # Per triangle: 18 corner floats in, 32 coefficients and 4 meta out.
    rep["bound_ms"], rep["bound_by"] = bound_ms(x["T"] * 216,
                                                x["T"] * FRONT_OPS)
    rep_r = reports["raster_shade_tiles"]

    def runners(key):
        table, data, bins, params, lights, rkw, layout = timing[key][1]
        common = (table, data, bins["seg_start"], bins["seg_count"], params,
                  lights)
        wl = binning.occupied_worklist(bins["seg_count"])
        return (lambda: raster._raster_cuda(*common, layout=layout,
                                            mode="base", worklist=wl,
                                            spans=bins.get("spans"), **rkw),
                lambda: raster.raster_shade_tiles_plain(*common,
                                                        layout=layout, **rkw))

    symbol = KERNELS["raster_shade_tiles"]["symbol"]
    run_kernel, run_plain = runners("suzanne/dense")
    rep_r["ms"] = kernel_device_ms(run_kernel, 50, symbol)
    rep_r["ms_events"] = event_ms(run_kernel, 200)
    rep_r["plain_ms"] = event_ms(run_plain, 10)
    rx, (table, data, bins, params, lights, rkw, _) = timing["suzanne/dense"]
    rep_r["bound_ms"], rep_r["bound_by"] = raster_bound(
        "raster_shade_tiles (suzanne dense)", rx, table, bins,
        tile_twin(data, bins, params, lights, rkw), (16, 256, W // 256),
        W * H)
    tile_walk("raster_shade_tiles (suzanne dense)", table, data, bins,
              params, lights, rkw)
    # The san_miguel_small flat layout, for the record.
    run_kernel, run_plain = runners("san_miguel_small/flat")
    rep_r["ms_san_miguel_small_flat"] = kernel_device_ms(run_kernel, 20,
                                                         symbol)
    rep_r["plain_ms_san_miguel_small_flat"] = event_ms(run_plain, 3)
    for name in ("front_end", "raster_shade_tiles"):
        print_time(name, reports[name])
    print(f"[time] raster_shade_tiles san_miguel_small flat: kernel "
          f"{rep_r['ms_san_miguel_small_flat']} ms, twin "
          f"{rep_r['plain_ms_san_miguel_small_flat']:.6f} ms")
    phase_bins(device, reports)


def print_time(name, rep, where="suzanne"):
    print(f"[time] {name} ({where}): kernel {rep['ms']} ms (profiler "
          f"device time), {rep['ms_events']:.6f} ms (events, wrapper "
          f"included); twin {rep['plain_ms']:.6f} ms; bound "
          f"{rep['bound_ms']:.6f} ms ({rep['bound_by']})")


def listed_pairs(bins):
    """(triangle id, tile or cell id) of each binned pair, in list order:
    the dense rows' first ``seg_count`` entries, or the flat / micro
    ``pair_tri`` segments."""
    import torch

    counts = bins["seg_count"].long()
    device = counts.device
    tile = torch.repeat_interleave(torch.arange(counts.numel(),
                                                device=device), counts)
    slot = (torch.arange(tile.numel(), device=device)
            - (torch.cumsum(counts, 0) - counts)[tile])
    if bins["layout"] == "dense":
        tri = bins["bin_rows"][tile, slot]
    else:
        tri = bins["pair_tri"][bins["seg_start"].long()[tile] + slot]
    return tri.long(), tile


def mode_check_text(mode, diff):
    if mode == "vis":
        return "ids bitwise"
    return ("G-buffer bitwise" if gbuffer_mode(mode)
            else f"RGBA max diff {diff:g} LSB")


def tile_twin(data, bins, params, lights, rkw):
    """The tile raster's twin on these bins in texf mode, as a function of
    a 44-column table (``raster_bound``'s winner count)."""
    from compute_renderer_torch.backends import raster

    return lambda table: raster.raster_shade_tiles_plain(
        table, data, bins["seg_start"], bins["seg_count"], params, lights,
        layout=bins["layout"], mode="texf", **rkw)


def micro_twin(bins, params, lights, mkw):
    """The micro raster's twin in texf mode, as ``tile_twin``."""
    from compute_renderer_torch.backends import micro

    return lambda table: micro.raster_shade_micro_plain(
        table, bins["pair_tri"], bins["seg_start"], bins["seg_count"],
        params, lights, mode="texf", **mkw)


def raster_bound(tag, x, table, bins, twin, grid, frame_pixels,
                 pixel_bytes=8, winner_rows=True):
    """Least time of a raster launch on this run's data.

    Operations: SAMPLE_OPS for each (pair, pixel sample inside the
    triangle's bounding box and the pair's tile or cell); no other sample
    can be covered. Bytes: the WALK_COLUMNS of each binned triangle's row,
    the rest of the row only for the triangles that win a pixel, 4 B a
    pair, the segments, and the outputs (``pixel_bytes`` a pixel: RGBA and
    key, or the texf G-buffer's planes and the key). The vis mode reads no
    winner's row (``winner_rows`` False): it writes the id the walk
    carries. ``grid`` is (tile
    height, tile width, tiles a row) of the pairs' tiles or cells. The
    winners come from ``twin`` (the raster's twin as a function of the
    table) run on a texf table whose TextureInfo offset column holds the
    triangle id, which the G-buffer copies from each pixel's winner."""
    import torch

    from compute_renderer_torch.backends import common, raster

    th, tw, cols = grid
    tri, tile = listed_pairs(bins)
    T = x["T"]
    corners = x["pos_soa"].to(torch.float32).permute(0, 2, 1).reshape(
        3 * T, 3)
    _, screen = common.vertex_stage(corners, x["vp"], x["eff"], W, H)
    sx = screen[:, 0].reshape(3, T)[:, tri]
    sy = screen[:, 1].reshape(3, T)[:, tri]
    x0 = ((tile % cols) * tw).to(torch.float32)
    y0 = (torch.div(tile, cols, rounding_mode="floor") * th).to(
        torch.float32)

    def extent(lo, hi, origin, size):
        first = torch.maximum(torch.ceil(lo), origin)
        last = torch.minimum(torch.floor(hi), origin + (size - 1))
        return torch.clamp(last - first + 1, min=0).to(torch.int64)

    samples = int((extent(sx.min(0).values, sx.max(0).values, x0, tw)
                   * extent(sy.min(0).values, sy.max(0).values, y0, th)
                   ).sum())
    tagged = torch.zeros((table.shape[0], raster.TEX_TRI_TABLE_WIDTH),
                         dtype=torch.float32, device=table.device)
    tagged[:, :32] = table[:, :32]
    tagged[:, 41] = torch.arange(table.shape[0], device=table.device,
                                 dtype=torch.float32)
    gbuf, key = twin(tagged)
    winners = int(torch.unique(gbuf[5][key.view(torch.int32) != -1]).numel())
    binned = int(torch.unique(tri).numel())
    pairs = int(tri.numel())
    row = table.shape[1]
    rest = (row - WALK_COLUMNS) * 4 if winner_rows else 0
    nbytes = (binned * WALK_COLUMNS * 4 + winners * rest
              + pairs * 4 + bins["seg_count"].numel() * 8
              + frame_pixels * pixel_bytes)
    ms, by = bound_ms(nbytes, samples * SAMPLE_OPS)
    print(f"[bound] {tag}: {pairs} pairs, {samples} bbox samples, {binned} "
          f"binned and {winners} winning triangles of {row} columns, "
          f"{nbytes} B -> {ms:.6f} ms ({by})")
    return ms, by


def micro_cases():
    """(name, model, effect, eye, path) of the micro kernel phase."""
    from compute_renderer_torch.core.effects import Effect

    return (
        ("san_miguel", SAN_MIGUEL, None, SAN_MIGUEL_EYE, "auto"),
        ("san_miguel_small", "san_miguel_small.obj", None, SAN_MIGUEL_EYE,
         "micro"),
        ("suzanne+mirage", "suzanne.obj", Effect.mirage(0.6, 0.7, 0.3),
         (0.0, 0.0, 3.0), "micro"),
        ("san_miguel_small+voxelize", "san_miguel_small.obj",
         Effect.voxelize(0.5, 1.0), SAN_MIGUEL_EYE, "micro"),
    )


def check_expand(name, meta, pair_cap, ntx, num_cells, report):
    """Expansion kernel vs twin (bitwise on the valid range, the sentinel
    tail, total equal); returns the kernel's outputs."""
    import torch

    from compute_renderer_torch.backends import expand

    args = (meta[3], meta[2], meta[0], meta[1])
    kw = dict(pair_cap=pair_cap, ntx_t=ntx, num_cells=num_cells)
    ck, tk, nk = expand.expand_cells(*args, **kw)  # the card route
    cp, tp, np_ = expand.expand_cells_plain(*args, **kw)
    torch.cuda.synchronize()
    total = int(np_)
    require(int(nk) == total, f"expand {name}: total {int(nk)} != {total}")
    n = min(total, pair_cap)
    require(torch.equal(ck[:n], cp[:n]) and torch.equal(tk[:n], tp[:n]),
            f"expand {name}: pairs differ from the twin")
    require(bool((ck[n:] == num_cells).all()),
            f"expand {name}: tail is not the num_cells sentinel")
    print(f"[check] expand {name}: T={meta.shape[1]} pair_cap={pair_cap} "
          f"total={total} bitwise on [0, {n}), sentinel tail")
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), 0.0)
    return ck, tk, nk


def expand_stress_meta(T, ntx, nty, device):
    """(4, T) meta of single-cell triangles, but for one triangle a third
    of the way in whose 200 x 200 cell rectangle holds 40,000 cells: one
    expansion block owns far more slots than the others."""
    import numpy as np
    import torch

    rng = np.random.default_rng(6)
    x0 = rng.integers(0, ntx * 16, T)
    y0 = rng.integers(0, nty, T)
    rx, c = np.ones(T, np.int64), np.ones(T, np.int64)
    big = T // 3
    x0[big], y0[big], rx[big], c[big] = 3, 1, 200, 40_000
    return torch.from_numpy(np.stack([x0, y0, rx, c]).astype(
        np.int32)).to(device)


def check_micro(name, x, table, bins, ntx, nty, report, mode="base",
                outputs=None):
    """Micro raster kernel vs twin in ``mode``: keys bitwise, RGBA within
    1 LSB or the G-buffer bitwise, and the samples it counts tested equal
    to the twin's count; the kernel's (out, key) go in
    ``outputs["micro"]``."""
    import torch

    from compute_renderer_torch.backends import binning, micro, raster

    args = (table, bins["pair_tri"], bins["seg_start"], bins["seg_count"])
    kw = dict(height_padded=nty * 8, width_padded=ntx * 128)
    acc = torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                      device=table.device)
    rk, kk = micro.raster_shade_micro(*args, bins["tile_count"], x["eff"],
                                      x["vpos"], x["lwp"], x["lc"], x["li"],
                                      mode=mode, acc=acc, **kw)
    params, lights = raster.shading_inputs(x["eff"], x["vpos"], x["lwp"],
                                           x["lc"], x["li"])
    rp, kp = micro.raster_shade_micro_plain(*args, params, lights, mode=mode,
                                            **kw)
    torch.cuda.synchronize()
    diff, covered = compare_outputs(f"micro {name} {mode}", mode, rk, kk, rp,
                                    kp)
    samples = int(micro.samples_tested_plain(
        *args, params, width_padded=kw["width_padded"]))
    require(int(acc[4]) == samples and not bool(acc[:4].any()),
            f"micro {name} {mode}: the kernel counts {acc.tolist()}, the "
            f"twin {samples} samples")
    what = mode_check_text(mode, diff)
    counts = bins["seg_count"]
    pairs = max(int(counts.sum()), 1)
    print(f"[check] micro {name} {mode}: keys bitwise, {what}, samples "
          f"tested {samples} as the twin's ({samples / pairs:.2f} a pair), "
          f"covered {covered}, pairs "
          f"{int(bins['total_pairs'])}, occupied tiles "
          f"{int((bins['tile_count'] > 0).sum())} of "
          f"{bins['tile_count'].numel()}, densest cell {int(counts.max())} "
          f"pairs, mean occupied cell "
          f"{float(counts[counts > 0].float().mean()):.1f}")
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), diff)
    if outputs is not None:
        outputs["micro"] = (rk, kk)
    return params, lights


def phase_micro_kernels(device, reports):
    import torch

    from compute_renderer_torch.backends import binning, cuda, expand, front
    from compute_renderer_torch.backends import micro
    from compute_renderer_torch.bench.profiling import event_ms

    ntx, nty = (W + 127) // 128, (H + 7) // 8
    num_cells = ntx * nty * 16
    timing = None
    for name, model, effect, eye, path in micro_cases():
        scene = bench_scene(model, effect, eye)
        require(cuda.resolve_path(path, scene.total_tris) == "micro",
                f"{name} does not take the micro path")
        for _ in range(3):
            scene.update(DT)
        x = frame_inputs(scene, device)
        table, meta = check_front(name, x, False, reports["front_end"],
                                  tile=(8, 8))
        total = int(meta[3].sum())
        pair_cap = cuda.grow_pair_cap(0, max(total, num_cells, 1024))
        check_expand(name, meta, pair_cap, ntx, num_cells,
                     reports["expand_cells"])
        if name == "san_miguel_small":  # an overflowing capacity
            check_expand(name, meta, 1024, ntx, num_cells,
                         reports["expand_cells"])
        if name == "san_miguel":  # uneven blocks at the same scale
            stress = expand_stress_meta(x["T"], ntx, nty, device)
            need = int(stress[3].sum())
            # The big triangle's slots start at T // 3: the second
            # capacity ends inside them.
            for cap in (cuda.grow_pair_cap(0, need), x["T"] // 3 + 20_000):
                check_expand("one 40,000-cell triangle", stress, cap, ntx,
                             num_cells, reports["expand_cells"])
        keys, tris, total_t = expand.expand_cells(
            meta[3], meta[2], meta[0], meta[1], pair_cap=pair_cap,
            ntx_t=ntx, num_cells=num_cells)
        check_bin_sort(f"micro {name}", keys, tris, total_t, num_cells,
                       reports["bin_sort"], group=16)
        bins = binning.bin_cells_sort_meta(meta[3], meta[2], meta[0],
                                           meta[1], ntx, nty, pair_cap)
        require(int(bins["pair_needed"]) == 0, f"micro {name}: overflow")
        params, lights = check_micro(name, x, table, bins, ntx, nty,
                                     reports["raster_shade_micro"])
        for y_offset in (0, SHADING_STRIPE_ROWS["micro"]):
            check_shading(f"{name} micro path", [x[k] for k in SHADING_KEYS],
                          y_offset, reports["shading_params"])
        if timing is None:  # San Miguel: the micro main path's shapes
            timing = (x, meta, pair_cap, table, bins, params, lights)

    x, meta, pair_cap, table, bins, params, lights = timing
    # The front end at 8x8 cells on 998,784 triangles (printed; the JSON
    # record keeps the tile main path's shapes for this kernel).
    args = (x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"])
    kw = dict(width=W, height=H, tile_h=8, tile_w=8)
    rep = {
        "ms": kernel_device_ms(lambda: front._front_end_cuda(*args, **kw),
                               20, KERNELS["front_end"]["symbol"]),
        "ms_events": event_ms(lambda: front._front_end_cuda(*args, **kw),
                              50),
        "plain_ms": event_ms(lambda: front.front_end_plain(*args, **kw), 5),
    }
    rep["bound_ms"], rep["bound_by"] = bound_ms(x["T"] * 216,
                                                x["T"] * FRONT_OPS)
    print_time("front_end", rep, "san_miguel 8x8")

    eargs = (meta[3], meta[2], meta[0], meta[1])
    ekw = dict(pair_cap=pair_cap, ntx_t=ntx, num_cells=num_cells)
    rep = reports["expand_cells"]
    rep["ms"] = kernel_device_ms(lambda: expand._expand_cuda(*eargs, **ekw),
                                 50, KERNELS["expand_cells"]["symbol"])
    rep["ms_events"] = event_ms(lambda: expand._expand_cuda(*eargs, **ekw),
                                200)
    rep["plain_ms"] = event_ms(
        lambda: expand.expand_cells_plain(*eargs, **ekw), 20)
    # The closest single PyTorch call: tri_of_pair alone, each triangle id
    # repeated by its cover count (no cell ids, no sentinel tail); the
    # device time of every kernel it launches, as the expansion's own.
    ids = torch.arange(x["T"], dtype=torch.int32, device=device)
    total = int(meta[3].sum())
    library = lambda: torch.repeat_interleave(ids, meta[3],
                                              output_size=total)
    rep["library_ms"] = kernel_device_ms(library, 50, None)
    if rep["ms"] is None:  # the profiler recorded nothing: both by events
        rep["library_ms"] = event_ms(library, 50)
    # The bytes the function must move: each triangle's count c, the rect
    # (rx, x0, y0) of the live triangles only (the kernel reads no culled
    # triangle's rect), 8 B a slot out.
    alive = int((meta[3] > 0).sum())
    rep["bound_ms"], rep["bound_by"] = bound_ms(
        x["T"] * 4 + alive * 12 + pair_cap * 8, pair_cap * EXPAND_OPS)
    print_time("expand_cells", rep, "san_miguel")
    print(f"[time] expand_cells (san_miguel): {alive} of {x['T']} "
          f"triangles live; torch.repeat_interleave of the triangle ids by "
          f"c ({total} pairs, tri_of_pair alone) {rep['library_ms']} ms "
          f"(device time of all its launches), {event_ms(library, 50):.6f} "
          f"ms (events, call included)")

    # The bin sort at San Miguel's shapes: the kernel, its twin and torch's
    # stable sort with the gather and the searchsorted it replaces.
    keys, tris, total_t = expand._expand_cuda(*eargs, **ekw)
    run = lambda: binning._bin_sort_cuda(keys, tris, total_t, num_cells,  # noqa: E731
                                         16, binning.CAP_NONE, None, 0)
    rep = reports["bin_sort"]
    rep["ms"] = kernel_device_ms(run, 50, KERNELS["bin_sort"]["symbol"])
    rep["ms_events"] = event_ms(run, 200)
    rep["plain_ms"] = event_ms(lambda: binning.bin_sort_plain(
        keys, tris, total_t, num_cells, group=16), 20)
    bounds = torch.arange(num_cells + 1, dtype=torch.int32, device=device)

    def library():
        skeys, order = torch.sort(keys, stable=True)
        return tris[order], torch.searchsorted(skeys, bounds, side="left",
                                               out_int32=True)

    rep["library_ms"] = kernel_device_ms(library, 50, None)
    if rep["library_ms"] is None:
        rep["library_ms"] = event_ms(library, 50)
    rep["bound_ms"], rep["bound_by"] = sort_bound(keys, total_t, num_cells,
                                                  "micro")
    print_time("bin_sort", rep, f"san_miguel, {int(total_t)} pairs")
    print_sort_split(f"micro san_miguel, {int(total_t)} pairs", run)
    print(f"[time] bin_sort (san_miguel): torch.sort(stable) + gather + "
          f"searchsorted {rep['library_ms']} ms (device time of all their "
          f"launches)")

    margs = (table, bins["pair_tri"], bins["seg_start"], bins["seg_count"])
    mkw = dict(height_padded=nty * 8, width_padded=ntx * 128)
    rep = reports["raster_shade_micro"]
    rep["ms"] = kernel_device_ms(
        lambda: micro._micro_cuda(*margs, bins["tile_count"], params,
                                  lights, **mkw),
        20, KERNELS["raster_shade_micro"]["symbol"])
    rep["ms_events"] = event_ms(
        lambda: micro._micro_cuda(*margs, bins["tile_count"], params,
                                  lights, **mkw), 50)
    rep["plain_ms"] = event_ms(
        lambda: micro.raster_shade_micro_plain(*margs, params, lights,
                                               **mkw), 3)
    rep["bound_ms"], rep["bound_by"] = raster_bound(
        "raster_shade_micro (san_miguel)", x, table, bins,
        micro_twin(bins, params, lights, mkw), (8, 8, ntx * 16),
        nty * 8 * ntx * 128)
    micro_walk("raster_shade_micro (san_miguel)", table, bins, params,
               lights, mkw)
    print_time("raster_shade_micro", rep, "san_miguel")


def check_golden(tag, frames, golden):
    """Each frame within max(2, H*W/500) pixels off by more than 2 LSB of
    the JAX package's golden frame, and not empty."""
    import numpy as np

    budget = max(2, H * W // 500)
    for i, img in enumerate(frames):
        require(img.shape == (H, W, 4) and img.dtype == np.uint8,
                f"{tag} frame {i}: shape {img.shape} {img.dtype}")
        d = np.abs(img.astype(np.int32) - golden[i].astype(np.int32))
        ndiff = int((d > 0).any(axis=-1).sum())
        nbad = int((d > 2).any(axis=-1).sum())
        require(nbad <= budget, f"{tag} frame {i}: {nbad} pixels differ from"
                f" the golden frame by more than 2 LSB (budget {budget})")
        covered = int((img != np.array([0, 0, 255, 255], np.uint8))
                      .any(axis=-1).sum())
        require(covered > 0, f"{tag} frame {i}: nothing rendered")
        print(f"[{tag}] frame {i}: matches golden ({ndiff} px differ, {nbad} "
              f"by more than 2 LSB, max {int(d.max())} LSB), covered "
              f"{covered} px")


def phase_main_path(device, card, reports):
    import numpy as np

    from compute_renderer_torch import Renderer
    from compute_renderer_torch.backends import raster

    scene = bench_scene()
    renderer = Renderer(scene.mesh, W, H, device=device,
                        **scene.renderer_options())
    golden = np.load(GOLDEN)["rgba"]

    tile_kernels = ("front_end", "bin_tiles_dense", "shading_params",
                    "raster_shade_tiles")
    reset_counts()
    batch = [scene.update(DT) for _ in range(3)]
    frames = [renderer.render(u) for u in batch]
    launches = {name: launch_count(counters()[name])
                for name in tile_kernels}
    # The first frame tunes the tile shape: each candidate's graph is
    # captured (an eager warm-up and the capture); the frames replay the
    # winner's.
    print(f"[main] launches over 3 render() frames (the tuner's captures; "
          f"replays tick no counter): {launches}; table copies "
          f"{raster.kernel_table.copies}")
    require_front_tables("main path")
    for name, n in launches.items():
        require(n >= CAPTURE_LAUNCHES,
                f"main path launched the {name} kernel {n} times")
        reports[name]["launches"] = n
    check_texture_launches("main path", read_counts(), "base", "nearest",
                           reports)
    require(not renderer.flush_overflow(), "overflow on the main path")
    check_golden("main", frames, golden)
    check_graph_equals_eager("main", renderer, batch, frames)
    note_tuner("suzanne", renderer)
    compare_eager_graph("suzanne", renderer, scene, card, TILE_LAYERS)
    kernels = GRAPH_ROWS["suzanne"]["graph"]["kernels"]
    print(f"[main] the Suzanne graph: {kernels:.1f} kernels a frame (at "
          f"most {MAX_GRAPH_KERNELS}, the per-frame uniform and frame "
          f"copies of render_batch_device included); card: {card}")
    require(0 < kernels <= MAX_GRAPH_KERNELS,
            f"the Suzanne graph runs {kernels:.1f} kernels a frame (at most "
            f"{MAX_GRAPH_KERNELS})")


# The tile path's layers in a profile: the front, the binning stage's
# kernel, the shading parameters and the raster (the rest is "other").
TILE_LAYERS = {
    "front_end": ("front_kernel",),
    "bin_tiles_dense": ("bin_rows_kernel", "bin_scan_kernel"),
    "flat bin sort": ("expand_kernel", "bin_sort_"),
    "shading_params": ("shading_params_kernel",),
    "raster_shade_tiles": ("raster_kernel",),
}
# Kernels a frame of the Suzanne graph, by profile_batch's count.
MAX_GRAPH_KERNELS = 12


# A graph's eager warm-up and its capture: the launch counters tick on
# both, never on a replay (engine/renderer.py).
CAPTURE_LAUNCHES = 2
# Every main-path row's eager and graph numbers, and each tile-path row's
# tuned tile shape, as the phases measure them (phase 14 prints them
# together).
GRAPH_ROWS = {}
TUNED_ROWS = {}


def batch_slopes(renderer, make_batch, sizes):
    """bench.py's batch-slope method for the eager loop and the replayed
    graphs of one renderer, in turns: ``sizes`` maps "eager" and "graph"
    to (small, large) batch sizes; after a checked warm-up of every size,
    ROUNDS rounds time each mode's two batches (unchecked, fenced), eager
    first in even rounds and graph first in odd ones. Returns {mode:
    (ms/frame by slope, wall ms/frame at the large batch)}, best of
    ROUNDS."""
    for mode, pair in sizes.items():
        for n in pair:
            renderer.render_batch_device(make_batch(n),
                                         eager=mode == "eager")
    renderer.fence_pending()
    best = {}
    modes = list(sizes)
    for r in range(ROUNDS):
        for mode in (modes if r % 2 == 0 else modes[::-1]):
            for n in sizes[mode]:
                batch = make_batch(n)
                t0 = time.perf_counter()
                renderer.render_batch_device(batch, check=False,
                                             eager=mode == "eager")
                renderer.fence_pending()
                t = time.perf_counter() - t0
                best[mode, n] = min(best.get((mode, n), float("inf")), t)
    require(not renderer.flush_overflow(), "overflow during the batch runs")
    return {mode: ((best[mode, large] - best[mode, small])
                   / (large - small) * 1e3, best[mode, large] / large * 1e3)
            for mode, (small, large) in sizes.items()}


def check_graph_equals_eager(tag, renderer, batch, frames):
    """The graph frames ``frames`` (K host arrays, or a (K, H, W, 4)
    stack) of ``batch`` equal the eager loop's frames of the same
    uniforms on the same renderer, bitwise. Run after the launch counts
    are read: the eager frames tick them."""
    import numpy as np

    eager = renderer.render_batch_device(batch, eager=True).cpu().numpy()
    require(np.array_equal(np.asarray(frames), eager),
            f"{tag}: the replayed graph's frames differ from the eager "
            "frames")
    print(f"[graph] {tag}: {len(batch)} graph frames bitwise equal to the "
          "eager frames")


def print_profile(tag, p, slope_ms):
    """Prints a ``profiling.profile_batch`` result: busy time and kernels
    a frame, the layer split, the idle share against the batch's own wall
    (profiler on) and against the unprofiled slope, the top kernels."""
    split = ", ".join(f"{k} {v:.6f}" for k, v in p["by_layer"].items())
    texture = ", ".join(f"{k} {v:.1f} kernels/frame"
                        for k, v in p["texture_kernels"].items())
    per_frame = p["wall_ms"] / p["frames"]
    print(f"[profile] {tag}: {p['frames']} frames (profiler on, wall "
          f"{p['wall_ms']:.3f} ms, {per_frame:.6f} ms/frame): device busy "
          f"{p['busy_ms']:.6f} ms/frame in {p['kernels']:.1f} kernels/frame "
          f"({split}{'; ' + texture if texture else ''}); idle share "
          f"against this batch's wall {1 - p['busy_ms'] / per_frame:.4f}, "
          f"against the unprofiled slope {1 - p['busy_ms'] / slope_ms:.4f}")
    for ms, count, key in p["rows"][:8]:
        print(f"[profile]   {ms:9.6f} ms/frame  x{count // p['frames']:<3d} "
              f"{key[:80]}")


def compare_eager_graph(tag, renderer, scene, card, layers,
                        eager_sizes=(BATCH_SMALL, BATCH_LARGE)):
    """A main-path row's eager loop against its replayed graph on one
    renderer, in one call: the slopes (in turns; the eager loop of the
    slow texture rows at smaller batches, printed), the host's CUDA calls
    a frame (at most 3 through the graph), and a profiled 16-frame batch
    of each — the eager one for the layer split and texture ranges, the
    graph one for its busy time and kernels. Stored in GRAPH_ROWS."""
    from compute_renderer_torch.bench import profiling

    def make_batch(n):
        return [scene.update(DT) for _ in range(n)]

    slopes = batch_slopes(renderer, make_batch,
                          {"eager": eager_sizes,
                           "graph": (BATCH_SMALL, BATCH_LARGE)})
    calls = {mode: profiling.host_calls_per_frame(renderer, make_batch,
                                                  eager=mode == "eager")
             for mode in slopes}
    require(calls["graph"] is not None and calls["graph"] <= 3,
            f"{tag}: the graph batch costs the host {calls['graph']} CUDA "
            "calls a frame (at most 3)")
    prof = {mode: profiling.profile_batch(renderer, make_batch(16), layers,
                                          eager=mode == "eager")
            for mode in slopes}
    busy_by = "profiler"
    if not prof["graph"]["busy_ms"]:
        # The profiler saw no kernel of the replays: the device time of
        # back-to-back replays instead (an upper bound of the busy time).
        prof["graph"]["busy_ms"] = profiling.event_ms(
            renderer.frame_graph(scene.update(DT)).graph.replay, 20)
        busy_by = "CUDA events around back-to-back replays"
    require(not renderer.flush_overflow(), f"{tag}: overflow in the runs")
    for mode in ("eager", "graph"):
        print_profile(f"{tag} {mode}", prof[mode], slopes[mode][0])
    note_sort_kernels(f"{tag} graph", prof["graph"])
    glue = torch_glue_kernels(prof["graph"]["rows"])
    require(not glue, f"{tag}: the graph runs torch's {glue}")
    row = {mode: {"slope_ms": slopes[mode][0], "wall_ms": slopes[mode][1],
                  "busy_ms": prof[mode]["busy_ms"],
                  "kernels": prof[mode]["kernels"],
                  "host_calls": calls[mode],
                  "idle": 1 - prof[mode]["busy_ms"] / slopes[mode][0]}
           for mode in slopes}
    row["eager_sizes"] = eager_sizes
    row["busy_by"] = busy_by
    GRAPH_ROWS[tag] = row
    e, g = row["eager"], row["graph"]
    print(f"[bench] {tag} 1024x768 (cuda): graph {g['slope_ms']:.6f} "
          f"ms/frame by slope {BATCH_SMALL}->{BATCH_LARGE} (wall "
          f"{g['wall_ms']:.6f} at {BATCH_LARGE}), eager {e['slope_ms']:.6f} "
          f"(batches {eager_sizes[0]}->{eager_sizes[1]}; wall "
          f"{e['wall_ms']:.6f}), best of {ROUNDS} in turns; busy graph "
          f"{g['busy_ms']:.6f} ({busy_by}) in {g['kernels']:.1f} kernels, "
          f"idle {g['idle']:.4f}; eager {e['busy_ms']:.6f} in "
          f"{e['kernels']:.1f}, idle {e['idle']:.4f}; host calls a frame "
          f"graph {g['host_calls']}, eager {e['host_calls']} ; card: {card}")


# Each profiled graph's bin sort kernels: {row: {kernel: (ms, launches) a
# frame}}, printed again at the end.
SORT_PROFILES = {}


def note_sort_kernels(tag, p):
    """The bin sort's kernels (bin_sort_*) in a profiled batch of frames
    that each sort once: each kernel's device ms and launches a frame,
    printed and kept; at most SORT_LAUNCHES launches a frame."""
    frames = p["frames"]
    split = {key: (ms, count / frames) for ms, count, key in p["rows"]
             if "bin_sort_" in key}
    if not split:
        return
    launches = sum(c for _, c in split.values())
    SORT_PROFILES[tag] = split
    print(f"[sort] {tag}: {launches:g} bin_sort kernels a frame, "
          f"{sum(ms for ms, _ in split.values()):.6f} ms: " + "; ".join(
              f"{short_name(k)} {ms:.6f} ms x{c:g}" for k, (ms, c) in sorted(
                  split.items(), key=lambda kv: -kv[1][0])))
    require(launches <= SORT_LAUNCHES,
            f"{tag}: {launches:g} bin_sort kernels a frame (at most "
            f"{SORT_LAUNCHES})")


def torch_glue_kernels(rows):
    """The kernels among a profile's rows (``profile_batch``'s) that are
    torch's sort, searchsorted or running max (``TORCH_GLUE``), not the
    bin sort's own."""
    return sorted({key for _, _, key in rows if "bin_sort_" not in key
                   and any(g in key.lower() for g in TORCH_GLUE)})


def profile_flat_graph(tag, renderer, scene):
    """A flat-layout tile row's replayed graph, profiled over 16 frames:
    its layers (the expansion and the bin sort as "flat bin sort"), and
    no torch sort, searchsorted or running max in it."""
    from compute_renderer_torch.bench import profiling

    p = profiling.profile_batch(renderer, [scene.update(DT)
                                           for _ in range(16)], TILE_LAYERS)
    require(not renderer.flush_overflow(), f"{tag}: overflow")
    print_profile(f"{tag} graph", p, p["wall_ms"] / p["frames"])
    note_sort_kernels(f"{tag} graph", p)
    glue = torch_glue_kernels(p["rows"])
    require(not glue, f"{tag}: the graph runs torch's {glue}")
    require(p["by_layer"]["flat bin sort"] > 0 or not p["busy_ms"],
            f"{tag}: the graph runs no flat bin sort kernel")


def note_tuner(tag, renderer):
    """Prints and keeps a tile-path row's tuned tile shape and the tuner's
    timings (best seconds of each candidate on the row's first frames)."""
    shape = (renderer.options.get("tile_h"), renderer.options.get("tile_w"))
    timings = {f"{h}x{w}": round(t * 1e3, 4)
               for (h, w), t in renderer.tile_timings.items()}
    require(timings and shape in renderer.tile_timings,
            f"{tag}: the tile tuner did not run (options {renderer.options})")
    TUNED_ROWS[tag] = (shape, timings)
    print(f"[tune] {tag}: picked {shape[0]}x{shape[1]}; best ms of each "
          f"candidate {timings}")


def phase_micro_main_path(device, card, reports):
    import numpy as np

    from compute_renderer_torch import Renderer
    from compute_renderer_torch.backends import (
        common, cuda, micro, raster, texture)

    scene = bench_scene(SAN_MIGUEL, eye=SAN_MIGUEL_EYE)
    require(scene.total_tris == 998_784, f"San Miguel has {scene.total_tris}"
            " triangles")
    renderer = Renderer(scene.mesh, W, H, device=device,
                        **scene.renderer_options())
    golden = np.load(GOLDEN_MICRO)["rgba"]
    names = ("front_end", "expand_cells", "bin_sort", "raster_shade_micro",
             "shading_params", "raster_shade_tiles", *texture.WRAPPERS)
    reset_counts()
    batch = [scene.update(DT) for _ in range(3)]
    frames = [renderer.render(u) for u in batch]
    launches = {name: launch_count(counters()[name]) for name in names}
    print(f"[main-micro] launches over 3 render() frames (calibration and "
          f"the graph's capture; replays tick no counter): {launches}; "
          f"table copies {raster.kernel_table.copies}")
    require_front_tables("micro main path")
    for name in ("front_end", "expand_cells", "bin_sort",
                 "raster_shade_micro", "shading_params"):
        require(launches[name] >= CAPTURE_LAUNCHES, f"the micro main path "
                f"launched the {name} kernel {launches[name]} times")
    require(launches["raster_shade_tiles"] == 0,
            "the micro main path launched the tile raster")
    check_texture_launches("micro main path", launches, "base", "nearest",
                           reports)
    # One capture: calibration left no frame to retry and re-capture.
    require(launches["expand_cells"] == CAPTURE_LAUNCHES
            and launches["front_end"] == CAPTURE_LAUNCHES + 1,
            "a frame overflowed and was captured again")
    for name in ("expand_cells", "bin_sort", "raster_shade_micro"):
        reports[name]["launches"] = launches[name]
    require(not renderer.flush_overflow(), "overflow on the micro main path")
    caps = cuda.default_caps("micro", scene.total_tris, W, H)
    print(f"[main-micro] calibrated pair_cap {renderer.options['pair_cap']} "
          f"(heuristic {caps['pair_cap']})")
    check_golden("main-micro", frames, golden)
    check_graph_equals_eager("main-micro", renderer, batch, frames)
    words, arrivals = common.merge_scratch(device, 768, 1024)
    require(bool((words == -1).all()) and not bool(arrivals.any()),
            "the micro raster's merge scratch is not clear after the "
            "graph's replays")
    compare_eager_graph("san_miguel", renderer, scene, card, MICRO_LAYERS)


def phase_san_miguel(device, reports):
    import numpy as np

    from compute_renderer_torch import Renderer, tracing

    scene = bench_scene("san_miguel_small.obj")
    uniforms = scene.update(DT)
    gpu = Renderer(scene.mesh, W, H, device=device,
                   **scene.renderer_options())
    tracing.reset()
    # The first frame tunes the tile shape and settles the capacities
    # (one retry at most); the second replays the winner's graph.
    gpu.render(uniforms)
    img = gpu.render(uniforms)
    launches = (launch_count("front_end"), launch_count("raster_shade_tiles"),
                launch_count("bin_sort"))
    require(launches[2] >= CAPTURE_LAUNCHES, f"san_miguel_small: the flat "
            f"layout's bin sort launched {launches[2]} times")
    reports["bin_sort.flat"]["launches"] = (
        reports["bin_sort.flat"].get("launches", 0) + launches[2])
    note_tuner("san_miguel_small", gpu)
    profile_flat_graph("san_miguel_small", gpu, scene)
    cpu = Renderer(scene.mesh, W, H, device="cpu",
                   **scene.renderer_options())
    ref = cpu.render(uniforms)
    d = np.abs(img.astype(np.int32) - ref.astype(np.int32))
    ndiff = int((d > 0).any(axis=-1).sum())
    budget = max(2, H * W // 500)
    require(ndiff <= budget, f"san_miguel_small: {ndiff} px differ from the "
            f"CPU twin path (budget {budget})")
    covered = int((img != np.array([0, 0, 255, 255], np.uint8))
                  .any(axis=-1).sum())
    require(covered > 0, "san_miguel_small: nothing rendered")
    print(f"[san_miguel_small] T={scene.total_tris} launches (front, raster, "
          f"bin sort)={launches} covered {covered} px, {ndiff} px differ from the CPU "
          f"twin path (max {int(d.max())} LSB), caps {gpu.options}")


def counters():
    """The launch-counted wrappers' names (``launches.<wrapper>`` of
    ``tracing.counters()``) by record name."""
    from compute_renderer_torch.backends import texture

    return {"front_end": "front_end",
            "raster_shade_tiles": "raster_shade_tiles",
            "expand_cells": "expand_cells",
            "raster_shade_micro": "raster_shade_micro",
            "bin_tiles_dense": "bin_tiles_meta",
            "shading_params": "shading_inputs",
            "bin_sort": "bin_sort",
            **{name: name for name in texture.WRAPPERS}}


def launch_count(wrapper, mode=None):
    """A kernel wrapper's calls (in ``mode``) since ``reset_counts()``."""
    from compute_renderer_torch import tracing

    return tracing.count(f"launches.{wrapper}"
                         + ("" if mode is None else f".{mode}"))


def reset_counts():
    from compute_renderer_torch import tracing
    from compute_renderer_torch.backends import raster

    raster.kernel_table.copies = 0
    tracing.reset()


def require_front_tables(tag):
    """The rasters of a main-path run read the front's own tables: no
    ``raster.kernel_table`` copy since ``reset_counts()``."""
    from compute_renderer_torch.backends import raster

    require(raster.kernel_table.copies == 0,
            f"{tag}: the rasters copied {raster.kernel_table.copies} tables "
            "instead of reading the front's")


def read_counts():
    """{record name: launches since reset_counts()}, per mode for the
    kernels that have modes."""
    from compute_renderer_torch.backends import front, raster

    modes = {"front_end": front.MODES, "raster_shade_tiles": raster.MODES,
             "raster_shade_micro": raster.MODES}
    out = {}
    for name, wrapper in counters().items():
        if wrapper in modes:
            for mode in modes[wrapper]:
                out[record(name, mode)] = launch_count(wrapper, mode)
        else:
            out[name] = launch_count(wrapper)
    return out


def load_ext_scenes():
    """The scenes of the extension rows, each OBJ synthesized and parsed
    once, with textures; the materials scenes share that parse and drop
    the atlas (their Kd rows are the MTL's either way). Returns {name:
    Scene}."""
    from compute_renderer_torch import CameraConfig, Scene, SceneConfig
    from compute_renderer_torch.io import objgen
    from compute_renderer_torch.io.model import Model

    scenes = {}
    for tag, model, ensure, count in (
            ("structured", objgen.STRUCTURED_NAME,
             objgen.ensure_structured_scene, 1_023_442),
            ("structured_tex", objgen.STRUCTURED_TEX_NAME,
             objgen.ensure_textured_scene, 36_322)):
        t0 = time.perf_counter()
        ensure()
        t_synth = time.perf_counter() - t0
        t0 = time.perf_counter()
        tex = Scene.from_config(SceneConfig(
            model_path=model, enable_textures=True,
            camera_config=CameraConfig.first_person(STRUCTURED_EYE)), W, H)
        t_parse = time.perf_counter() - t0
        mesh = tex.mesh
        require(mesh.num_triangles == count, f"{model}: "
                f"{mesh.num_triangles} triangles, expected {count}")
        require(mesh.face_kd is not None and mesh.has_textures,
                f"{model}: no face_kd or textures after the load")
        print(f"[load] {model}: synthesis {t_synth:.3f} s, load with "
              f"textures {t_parse:.3f} s; T={mesh.num_triangles}, "
              f"{mesh.positions.shape[0]} vertices, atlas "
              f"{mesh.texels.shape[0]} texels in {mesh.tex_table.shape[0]} "
              f"textures, {int((mesh.face_tex >= 0).sum())} textured faces")
        check_native_parse(model, tex.models[0].source, mesh)

        plain = dataclasses.replace(mesh, face_tex=None, texels=None,
                                    tex_table=None)
        scenes[f"{tag}+textures"] = tex
        scenes[f"{tag}+materials"] = scene_copy(
            tex, models=[Model(mesh=plain, source=f"{model} (materials)")])
        if tag == "structured_tex":
            scenes[f"{tag}+bilinear+ssaa2"] = scene_copy(
                tex, texture_filter="bilinear", ssaa=2)
    return scenes


MESH_FIELDS = ("positions", "normals", "uvs", "indices", "face_kd",
               "face_tex", "texels", "tex_table")


def check_native_parse(model, path, loaded):
    """The native parser (io/native.py, the route Model.load took for
    ``loaded``) against the port's Python loader on the same file: every
    array equal, dtype included; both parses timed."""
    import numpy as np

    from compute_renderer_torch.io import native
    from compute_renderer_torch.io.obj import load_obj

    require(native.enabled(), "CRT_DISABLE_NATIVE is set: the native parser "
            "is off")
    t0 = time.perf_counter()
    nat = native.load_obj(path, textures=True)
    t_native = time.perf_counter() - t0
    t0 = time.perf_counter()
    py = load_obj(path, textures=True)
    t_python = time.perf_counter() - t0
    for field in MESH_FIELDS:
        a, b, c = (getattr(m, field) for m in (nat, py, loaded))
        require(a is not None and b is not None and c is not None
                and a.dtype == b.dtype == c.dtype
                and np.array_equal(a, b) and np.array_equal(a, c),
                f"{model}: the native parse's {field} differs from the "
                "Python parse's")
    print(f"[load] {model}: native parse {t_native:.3f} s, Python parse "
          f"{t_python:.3f} s ({t_python / t_native:.1f}x); all "
          f"{len(MESH_FIELDS)} arrays equal ({', '.join(MESH_FIELDS)})")


def scene_copy(scene, **attrs):
    """A scene that shares ``scene``'s models (unless ``attrs`` replaces
    them) and animates apart from it: its own time, camera and lights."""
    out = copy.copy(scene)
    out.cameras = copy.deepcopy(scene.cameras)
    out.lights = copy.deepcopy(scene.lights)
    for k, v in attrs.items():
        setattr(out, k, v)
    return out


def mode_cases(scenes, modes):
    """(name, scene, mode, path) of a mode kernel phase: the structured
    scenes and a mirage frame of structured_scene_tex, on the path each
    main row takes (the mirage frame on both)."""
    from compute_renderer_torch.core.effects import Effect

    small = scene_copy(scenes["structured_tex+textures"])
    mirage = scene_copy(small, effect=Effect.mirage(0.6, 0.7, 0.3))
    big = scene_copy(scenes["structured+textures"])
    return [(name, scene, mode, path)
            for mode in modes
            for name, scene, path in (
                ("structured", big, "micro"),
                ("structured_tex", small, "tile"),
                ("structured_tex+mirage", mirage, "tile"),
                ("structured_tex+mirage", mirage, "micro"))]


# The renderer options each mode's kernel checks take: the mip rows of the
# anisotropic filter fill every column the texf_mip G-buffer copies.
MODE_OPTIONS = {"mat": {}, "texf": {},
                "vis": {"tex_mode": "deferred"},
                "texf_mip": {"tex_filter": "anisotropic"}}
# Bytes a pixel the rasters write: RGBA or the vis id, and the key; the
# G-buffers' planes (two lights) and the key.
PIXEL_BYTES = {"mat": 8, "vis": 8, "texf": (8 + 4 + 1) * 4,
               "texf_mip": (10 + 4 + 1) * 4}
# The front's bytes a triangle: 18 corner floats in, and the mode's inputs
# (kd 3; uv 6, kd 3 and TextureInfo 3 or mip rows 5), the rows and 4 meta
# ints out.
FRONT_BYTES = {"mat": 72 + 12 + 35 * 4 + 16, "texf": 72 + 48 + 44 * 4 + 16,
               "texf_mip": 72 + 56 + 46 * 4 + 16}


def front_record(mode):
    """The front's record of a raster mode (vis runs the base front)."""
    return "front_end" if mode == "vis" else record("front_end", mode)


# The texture stage each G-buffer or vis mode's tail launches.
TEXTURE_STAGES = {"texf": "texture_tail", "texf_mip": "texture_tail_mip",
                  "vis": "deferred_tail"}
FLAT_FILTERS = ("nearest", "bilinear")
MIP_FILTERS = ("trilinear", "anisotropic")
# Compulsory bytes of the texture stages, as this frame needs them: a tail
# reads every pixel's key (and the deferred tail its winner id) and writes
# its 4 B of RGBA, and reads a covered pixel's G-buffer planes (8 or 10 +
# 2 a light; the deferred tail its pair's triangle on the micro path);
# the texel gathers and the winners' vertices are not counted. mip_rows
# reads each vertex's position and uv once (20 B), a triangle's indices
# and slot, and writes its 5 floats (36 B a triangle).
MIP_ROWS_VERTEX_BYTES, MIP_ROWS_TRIANGLE_BYTES = 12 + 8, 12 + 4 + 20
# Float operations counted from csrc/texture.cu, roughly, a covered pixel:
# a bilinear tap ~30, the epilogue ~45 and ~20 a light (powf counted as
# 10); the deferred resolve ~120 and ~40 a light; mip_rows ~150 a
# triangle.
TAP_OPS, EPILOGUE_OPS, LIGHT_OPS, RESOLVE_OPS = 30, 45, 20, 120
FILTER_TAPS = {"nearest": 0.3, "bilinear": 1, "trilinear": 2,
               "anisotropic": 8}
MIP_ROWS_OPS = 150


def stage_ops(stage, tex_filter, lights):
    """Float operations a covered pixel of a texture tail."""
    ops = (TAP_OPS * FILTER_TAPS[tex_filter] + EPILOGUE_OPS
           + LIGHT_OPS * lights)
    if stage == "deferred_tail":
        ops += RESOLVE_OPS + 40 * lights
    return ops


def compare_rgba(tag, k, p, report):
    """A texture stage's (H, W, 4) RGBA against its plain version's on the
    same card tensors: within 1 LSB, the differing pixels printed (0
    expected)."""
    import torch

    torch.cuda.synchronize()
    require(k.shape == p.shape and k.dtype == p.dtype == torch.uint8,
            f"{tag}: RGBA {tuple(k.shape)} {k.dtype} against "
            f"{tuple(p.shape)} {p.dtype}")
    d = (k.to(torch.int32) - p.to(torch.int32)).abs().amax(dim=-1)
    n = int((d > 0).sum())
    worst = int(d.max()) if d.numel() else 0
    where = ""
    if n:
        ys, xs = torch.nonzero(d > 0, as_tuple=True)
        where = "; first " + ", ".join(
            f"({int(y)}, {int(x)}) {k[y, x].tolist()} vs {p[y, x].tolist()}"
            for y, x in zip(ys[:6], xs[:6]))
    print(f"[check] {tag}: RGBA max diff {worst} LSB, {n} px differ "
          f"of {d.numel()}{where}")
    require(worst <= 1, f"{tag}: RGBA differs by {worst} LSB from the "
            "plain version")
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0),
                                float(worst))


_STAGE_EXT = {}


def stage_ext(scene, x, device, tex_filter, tex_mode):
    """The mesh's texture inputs for a filter and mode, as the renderer
    uploads them (the mip pool built once a mesh)."""
    from compute_renderer_torch.backends import cuda

    k = (id(scene.mesh), tex_filter in MIP_FILTERS, tex_mode)
    if k not in _STAGE_EXT:
        _STAGE_EXT[k] = cuda.mesh_ext_tensors(
            scene.mesh, x["tri"], device, tex_filter=tex_filter,
            tex_mode=tex_mode)
    return _STAGE_EXT[k]


def check_mip_rows(tag, x, ext, tex_filter, report, wave=False):
    """``mip_rows`` against its plain version on a frame: bitwise with NaN
    positions equal (a wave frame within 1 ULP: its sinf inputs, as the
    front's table). Returns the kernel's rows."""
    import torch

    from compute_renderer_torch.backends import texture

    args = (x["positions"], x["tri"], ext["uvs"], ext["face_tex"],
            ext["tex_mips"], x["vp"], x["eff"], W, H, tex_filter)
    rk = texture.mip_rows(*args)
    rp = texture.mip_rows_plain(*args)
    torch.cuda.synchronize()
    nan_k, nan_p = torch.isnan(rk), torch.isnan(rp)
    require(torch.equal(nan_k, nan_p), f"mip_rows {tag}: NaN positions "
            "differ from the plain version")
    keep = ~nan_k
    worst = int(ulps(rk[keep], rp[keep]).max()) if keep.any() else 0
    limit = 1 if wave else 0
    print(f"[check] mip_rows {tag} {tex_filter}: T={rk.shape[0]}, worst "
          f"{worst} ULP (limit {limit}), {int(nan_k.any(1).sum())} rows "
          f"with NaN, lod > 0 in {int((rk[:, 1] > 0).sum())} rows")
    require(worst <= limit, f"mip_rows {tag}: {worst} ULP from the plain "
            f"version (limit {limit})")
    gap = torch.where(rk == rp, torch.zeros_like(rk), (rk - rp).abs())
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0),
                                float(gap[keep].max()) if keep.any()
                                else 0.0)
    return rk


def stage_calls(x, scene, mode, out, key, pair_tri, device, tex_filter):
    """(kernel call, plain call) of the mode's texture stage on a raster's
    output window ``out`` / ``key`` (H, W), under ``tex_filter``."""
    from compute_renderer_torch.backends import common, texture

    lights = (x["lc"], x["li"])
    if mode == "texf":
        ext = x["ext"]
        return (lambda packed=None: texture.texture_tail(
                    out, key, ext["texels"], *lights, tex_filter=tex_filter,
                    texels_packed=packed),
                lambda packed=None: texture.texture_tail_plain(
                    out, key, ext["texels"], *lights, tex_filter=tex_filter,
                    texels_packed=packed))
    if mode == "texf_mip":
        ext = x["ext"]
        args = (out, key, ext["texels"], ext["tex_mips"], *lights)
        return (lambda: texture.texture_tail_mip(*args,
                                                 tex_filter=tex_filter),
                lambda: texture.texture_tail_mip_plain(
                    *args, tex_filter=tex_filter))
    ext = stage_ext(scene, x, device, tex_filter, "deferred")
    world, screen = common.vertex_stage(x["positions"], x["vp"], x["eff"],
                                        W, H)
    rows = None
    if tex_filter in MIP_FILTERS:
        rows = texture.mip_rows(x["positions"], x["tri"], ext["uvs"],
                                ext["face_tex"], ext["tex_mips"], x["vp"],
                                x["eff"], W, H, tex_filter)
    args = (out, key, x["tri"], screen, world, x["normals"], ext["uvs"],
            x["eff"], ext.get("face_kd"), ext["face_tex"], ext["texels"],
            ext["tex_table"], x["vpos"], x["lwp"], *lights)
    kw = dict(tex_filter=tex_filter, tex_mips=ext.get("tex_mips"),
              rows=rows, pair_tri=pair_tri)
    return (lambda: texture.deferred_tail(*args, **kw),
            lambda: texture.deferred_tail_plain(*args, **kw))


def check_texture_stage(tag, x, scene, mode, out, key, pair_tri, reports,
                        device):
    """The mode's texture stage kernel against its plain version on a
    raster's real output (its (H, W) window, read in place), in every
    filter of the mode (texf: both pools too; vis: the mip rows held
    first); RGBA within 1 LSB."""
    import torch

    from compute_renderer_torch.io.textures import pack_pool_u8

    out, key = out[..., :H, :W], key[:H, :W]
    stage = TEXTURE_STAGES[mode]
    filters = {"texf": FLAT_FILTERS, "texf_mip": MIP_FILTERS,
               "vis": FLAT_FILTERS + MIP_FILTERS}[mode]
    for tex_filter in filters:
        if tex_filter in MIP_FILTERS:
            check_mip_rows(tag, x, x["ext"] if mode == "texf_mip" else
                           stage_ext(scene, x, device, tex_filter,
                                     "deferred"),
                           tex_filter, reports["mip_rows"])
        run, plain = stage_calls(x, scene, mode, out, key, pair_tri, device,
                                 tex_filter)
        before = launch_count(stage)
        compare_rgba(f"{stage} {tag} {tex_filter}", run(), plain(),
                     reports[stage])
        require(launch_count(stage) == before + 1,
                f"{stage} {tag}: the wrapper did not launch its kernel")
        if mode == "texf":
            packed = pack_pool_u8(scene.mesh.texels)
            require(packed is not None, f"{tag}: the atlas is not u8")
            packed = torch.from_numpy(packed).to(device)
            compare_rgba(f"{stage} {tag} {tex_filter} packed pool",
                         run(packed), plain(packed), reports[stage])


def time_texture_stages(stage_inputs, device, reports, modes):
    """Each texture stage's time beside its plain version's at the micro
    main rows' shapes (structured_scene.obj, 1024x768): texture_tail
    nearest (+textures), texture_tail_mip trilinear (+trilinear; the
    anisotropic time printed beside it), deferred_tail trilinear
    (+deferred trilinear) and mip_rows trilinear over 1,023,442
    triangles."""
    import torch

    from compute_renderer_torch.backends import texture
    from compute_renderer_torch.bench.profiling import event_ms, graph_ms

    for mode in modes:
        if mode not in TEXTURE_STAGES:
            continue
        x, scene, out, key, pair_tri = stage_inputs[mode]
        out, key = out[..., :H, :W], key[:H, :W]
        covered = int((key.view(torch.int32) != -1).sum())
        stage = TEXTURE_STAGES[mode]
        filters = {"texf": ("nearest", "bilinear"),
                   "texf_mip": ("trilinear", "anisotropic"),
                   "vis": ("trilinear", "nearest")}[mode]
        L = x["lc"].shape[0]
        for i, tex_filter in enumerate(filters):
            run, plain = stage_calls(x, scene, mode, out, key, pair_tri,
                                     device, tex_filter)
            rep = reports[stage] if i == 0 else {}
            rep["ms"] = kernel_device_ms(run, 20, KERNELS[stage]["symbol"])
            # The call captured as a graph: its device time without the
            # host's gaps (where the profiler records none, the kernel's).
            ms_graph = graph_ms(run, 50)
            if rep["ms"] is None:
                rep["ms"] = ms_graph
            print(f"[time] {stage} {tex_filter}: graph replay {ms_graph:.6f} "
                  "ms")
            rep["ms_events"] = event_ms(run, 50)
            rep["plain_ms"] = event_ms(plain, 3)
            # Every pixel's key (and id) and RGBA, a covered one's planes
            # (or its pair's triangle).
            per_pixel = 4 + 4 + (4 if mode == "vis" else 0)
            per_covered = 4 if mode == "vis" else 4 * out.shape[0]
            rep["bound_ms"], rep["bound_by"] = bound_ms(
                W * H * per_pixel + covered * per_covered,
                covered * stage_ops(stage, tex_filter, L))
            print_time(f"{stage} {tex_filter}", rep, f"structured {W}x{H}, "
                       f"{per_pixel} B a pixel and {per_covered} B a "
                       f"covered one, {covered} covered")
        if mode == "vis":
            ext = stage_ext(scene, x, device, "trilinear", "deferred")
            args = (x["positions"], x["tri"], ext["uvs"], ext["face_tex"],
                    ext["tex_mips"], x["vp"], x["eff"], W, H, "trilinear")
            rep = reports["mip_rows"]
            rep["ms"] = kernel_device_ms(lambda: texture.mip_rows(*args), 20,
                                         KERNELS["mip_rows"]["symbol"])
            ms_graph = graph_ms(lambda: texture.mip_rows(*args), 50)
            if rep["ms"] is None:
                rep["ms"] = ms_graph
            print(f"[time] mip_rows trilinear: graph replay {ms_graph:.6f} ms")
            rep["ms_events"] = event_ms(lambda: texture.mip_rows(*args), 50)
            rep["plain_ms"] = event_ms(lambda: texture.mip_rows_plain(*args),
                                       3)
            N = x["positions"].shape[0]
            rep["bound_ms"], rep["bound_by"] = bound_ms(
                N * MIP_ROWS_VERTEX_BYTES + x["T"] * MIP_ROWS_TRIANGLE_BYTES,
                x["T"] * MIP_ROWS_OPS)
            print_time("mip_rows trilinear", rep, f"structured, T={x['T']}, "
                       f"N={N}: {MIP_ROWS_VERTEX_BYTES} B a vertex, "
                       f"{MIP_ROWS_TRIANGLE_BYTES} B a triangle")


def check_texture_launches(tag, launches, mode, tex_filter, reports):
    """A main-path row's texture stages: the ones its mode runs launched
    (their counts added to the kernels' records), the others never."""
    ran = {TEXTURE_STAGES[mode]} if mode in TEXTURE_STAGES else set()
    if mode in ("texf_mip", "vis") and tex_filter in MIP_FILTERS:
        ran.add("mip_rows")
    if mode == "vis":
        ran.add("vertex_stage")
    for name in TEXTURE_KERNELS:
        n = launches[name]
        if name in ran:
            require(n >= CAPTURE_LAUNCHES, f"{tag}: the {name} kernel "
                    f"launched {n} times")
            reports[name]["launches"] = reports[name].get("launches", 0) + n
        else:
            require(n == 0, f"{tag}: the {name} kernel launched {n} times "
                    "on a row that does not run it")


def phase_mode_kernels(device, reports, scenes, modes):
    """The ``modes`` of the front, tile raster and micro kernels against
    their twins, then each mode kernel's time at its main path's shapes."""
    from compute_renderer_torch.backends import binning, cuda, front, micro
    from compute_renderer_torch.backends import raster
    from compute_renderer_torch.bench.profiling import event_ms

    timing, stage_inputs = {}, {}
    for name, scene, mode, path in mode_cases(scenes, modes):
        x = frame_inputs(scene, device, **MODE_OPTIONS[mode])
        fmode = "base" if mode == "vis" else mode
        outputs = {}
        if path == "micro":
            ntx, nty = (W + 127) // 128, (H + 7) // 8
            table, meta = check_front(name, x, False,
                                      reports[front_record(mode)],
                                      tile=(8, 8), mode=fmode)
            pair_cap = cuda.grow_pair_cap(0, max(int(meta[3].sum()),
                                                 ntx * nty * 16, 1024))
            bins = binning.bin_cells_sort_meta(meta[3], meta[2], meta[0],
                                               meta[1], ntx, nty, pair_cap)
            require(int(bins["pair_needed"]) == 0, f"micro {name}: overflow")
            params, lights = check_micro(
                name, x, table, bins, ntx, nty,
                reports[record("raster_shade_micro", mode)], mode=mode,
                outputs=outputs)
            timing.setdefault(("micro", mode), (x, table, bins, params,
                                                lights))
            if mode in TEXTURE_STAGES:
                check_texture_stage(f"micro {name}", x, scene, mode,
                                    *outputs["micro"], bins["pair_tri"],
                                    reports, device)
                stage_inputs.setdefault(mode, (x, scene, *outputs["micro"],
                                               bins["pair_tri"]))
            continue
        table, meta = check_front(name, x, False,
                                  reports[front_record(mode)], mode=fmode)
        caps = cuda.default_caps("tile", x["T"], W, H)
        inputs = check_raster(name, x, table, meta, caps,
                              reports[record("raster_shade_tiles", mode)],
                              mode=mode, outputs=outputs)
        if mode in TEXTURE_STAGES:
            check_texture_stage(f"tile {name}", x, scene, mode,
                                *outputs["dense"], None, reports, device)
        # The main path's tile shape and layout on the 36k textured scene:
        # the tuner picks 8x128 there, binned flat.
        timing.setdefault(("tile", mode), (x, inputs[(8, 128), "flat"]))

    for mode in modes:
        # Front and micro raster at the micro rows' shapes (structured
        # scene, 8x8 cells); the front at 16x256 on structured_scene_tex
        # is printed beside it.
        x, table, bins, params, lights = timing[("micro", mode)]
        args = (x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"])
        if mode != "vis":
            rep = reports[record("front_end", mode)]
            fkw = dict(width=W, height=H, tile_h=8, tile_w=8,
                       **front_modes(x, mode))
            rep["ms"] = kernel_device_ms(
                lambda: front._front_end_cuda(*args, **fkw), 20,
                KERNELS["front_end"]["symbol"])
            rep["ms_events"] = event_ms(
                lambda: front._front_end_cuda(*args, **fkw), 50)
            rep["plain_ms"] = event_ms(
                lambda: front.front_end_plain(*args, **fkw), 5)
            rep["bound_ms"], rep["bound_by"] = bound_ms(
                x["T"] * FRONT_BYTES[mode], x["T"] * FRONT_OPS)
            print_time(record("front_end", mode), rep, "structured 8x8")

        ntx, nty = (W + 127) // 128, (H + 7) // 8
        margs = (table, bins["pair_tri"], bins["seg_start"],
                 bins["seg_count"], bins["tile_count"], params, lights)
        mkw = dict(height_padded=nty * 8, width_padded=ntx * 128, mode=mode)
        rep = reports[record("raster_shade_micro", mode)]
        rep["ms"] = kernel_device_ms(lambda: micro._micro_cuda(*margs, **mkw),
                                     20, KERNELS["raster_shade_micro"]
                                     ["symbol"])
        rep["ms_events"] = event_ms(lambda: micro._micro_cuda(*margs, **mkw),
                                    50)
        rep["plain_ms"] = event_ms(
            lambda: micro.raster_shade_micro_plain(*margs[:4], params,
                                                   lights, **mkw), 3)
        rep["bound_ms"], rep["bound_by"] = raster_bound(
            f"{record('raster_shade_micro', mode)} (structured)", x, table,
            bins, micro_twin(bins, params, lights,
                             dict(height_padded=nty * 8,
                                  width_padded=ntx * 128)),
            (8, 8, ntx * 16), nty * 8 * ntx * 128, PIXEL_BYTES[mode],
            winner_rows=mode != "vis")
        print_time(record("raster_shade_micro", mode), rep, "structured")
        micro_walk(f"{record('raster_shade_micro', mode)} (structured)",
                   table, bins, params, lights,
                   dict(height_padded=nty * 8, width_padded=ntx * 128))

        # The tile raster at structured_scene_tex's shapes.
        x, (table, data, tbins, params, lights, rkw, layout) = \
            timing[("tile", mode)]
        common_args = (table, data, tbins["seg_start"], tbins["seg_count"],
                       params, lights)
        rep = reports[record("raster_shade_tiles", mode)]
        wl = binning.occupied_worklist(tbins["seg_count"])
        run = lambda: raster._raster_cuda(*common_args, layout=layout,
                                          mode=mode, worklist=wl,
                                          spans=tbins.get("spans"), **rkw)
        rep["ms"] = kernel_device_ms(run, 50,
                                     KERNELS["raster_shade_tiles"]["symbol"])
        rep["ms_events"] = event_ms(run, 100)
        rep["plain_ms"] = event_ms(
            lambda: raster.raster_shade_tiles_plain(
                *common_args, layout=layout, mode=mode, **rkw), 5)
        shape = f"{rkw['tile_h']}x{rkw['tile_w']}"
        rep["bound_ms"], rep["bound_by"] = raster_bound(
            f"{record('raster_shade_tiles', mode)} (structured_tex {shape})",
            x, table, tbins, tile_twin(data, tbins, params, lights, rkw),
            (rkw["tile_h"], rkw["tile_w"],
             rkw["width_padded"] // rkw["tile_w"]), W * H, PIXEL_BYTES[mode],
            winner_rows=mode != "vis")
        print_time(record("raster_shade_tiles", mode), rep,
                   f"structured_tex {shape} {layout}")
        tile_walk(f"{record('raster_shade_tiles', mode)} (structured_tex "
                  f"{shape} {layout})", table, data, tbins, params, lights,
                  rkw)
        if mode != "vis":
            fkw = dict(width=W, height=H, tile_h=16, tile_w=256,
                       **front_modes(x, mode))
            args = (x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"])
            ms = kernel_device_ms(lambda: front._front_end_cuda(*args, **fkw),
                                  50, KERNELS["front_end"]["symbol"])
            print(f"[time] {record('front_end', mode)} (structured_tex "
                  f"16x256, T={x['T']}): kernel {ms} ms")
    if "texf_mip" in modes:
        # The mip rows of wave frames: the corners move with the wave.
        from compute_renderer_torch.core.effects import Effect, WaveDirection

        for key in ("structured_tex+textures", "structured+textures"):
            scene = scene_copy(scenes[key], effect=Effect.wave(
                0.4, 3.0, 2.0, WaveDirection.VERTICAL))
            scene.update(0.5)
            x = frame_inputs(scene, device, tex_filter="anisotropic")
            for tex_filter in MIP_FILTERS:
                check_mip_rows(f"{key.split('+')[0]}+wave", x, x["ext"],
                               tex_filter, reports["mip_rows"], wave=True)
    time_texture_stages(stage_inputs, device, reports, modes)


# (golden row, scene, frames, path, mode): the suite's extension rows
# (bench/suite.py:101-144) and the tile raster's material mode.
EXT_ROWS = (
    ("materials", "structured+materials", 3, "micro", "mat"),
    ("textures", "structured+textures", 3, "micro", "texf"),
    ("tex_textures", "structured_tex+textures", 3, "tile", "texf"),
    ("tex_bilinear_ssaa2", "structured_tex+bilinear+ssaa2", 1, "tile",
     "texf"),
    ("tex_materials", "structured_tex+materials", 3, "tile", "mat"),
)


def note_bin_sort(row, path, launches, reports):
    """A structured row's bin sort: launched by its captures, on the micro
    path (its cells) or the tile path's flat layout (the dense rule sends
    these frames there); the count goes to that layout's record."""
    n = launches["bin_sort"]
    require(n >= CAPTURE_LAUNCHES, f"{row}: the bin sort kernel launched "
            f"{n} times")
    rec = "bin_sort" if path == "micro" else "bin_sort.flat"
    reports[rec]["launches"] = reports[rec].get("launches", 0) + n


def phase_ext_main_paths(device, card, reports, scenes):
    """Each extension row through Scene -> Renderer ->
    render_batch_device against the JAX package's golden frames, with the
    per-mode launch counts; then the micro rows' batch slope and
    profile."""
    import numpy as np

    from compute_renderer_torch import Renderer
    from compute_renderer_torch.backends import cuda

    golden = np.load(GOLDEN_EXT)
    renderers = {}
    for row, key, frames, path, mode in EXT_ROWS:
        scene = scenes[key]
        require(cuda.resolve_path("auto", scene.total_tris) == path,
                f"{row} does not take the {path} path")
        renderer = Renderer(scene.mesh, W, H, device=device,
                            **scene.renderer_options())
        reset_counts()
        batch = [scene.update(DT) for _ in range(frames)]
        imgs = renderer.render_batch_device(batch).cpu().numpy()
        launches = read_counts()
        require_front_tables(f"ext {row}")
        ran = {k: v for k, v in launches.items() if v}
        print(f"[ext] {row} ({key}, {path} path, {frames} frames): "
              f"launches {ran} (the captures), no table copy")
        raster_name = ("raster_shade_micro" if path == "micro"
                       else "raster_shade_tiles")
        for name in ("front_end", raster_name):
            n = launches[record(name, mode)]
            require(n >= CAPTURE_LAUNCHES, f"{row}: the "
                    f"{record(name, mode)} kernel launched {n} times")
            reports[record(name, mode)]["launches"] = (
                reports[record(name, mode)].get("launches", 0) + n)
        check_texture_launches(f"ext {row}", launches, mode,
                               scene.texture_filter, reports)
        other = ("raster_shade_tiles" if path == "micro"
                 else "raster_shade_micro")
        require(not any(launches[record(other, m)]
                        for m in ("base",) + MODE_KERNELS[other]),
                f"{row}: the {path} path launched {other}")
        if path == "micro":
            require(launches["expand_cells"] >= CAPTURE_LAUNCHES,
                    f"{row}: the expansion kernel did not run")
        note_bin_sort(row, path, launches, reports)
        require(not renderer.flush_overflow(), f"{row}: overflow")
        require(golden[row].shape[0] == frames,
                f"{row}: {golden[row].shape[0]} golden frames")
        check_golden(f"ext {row}", imgs, golden[row])
        check_graph_equals_eager(f"ext {row}", renderer, batch, imgs)
        if path == "tile":
            note_tuner(f"structured_tex {row}", renderer)
            profile_flat_graph(f"ext {row}", renderer, scene)
        renderers[row] = (renderer, scene)

    for row in ("materials", "textures"):
        renderer, scene = renderers[row]
        compare_eager_graph(f"structured +{row}", renderer, scene, card,
                            MICRO_LAYERS)


# (golden row, scene, tex_filter, tex_mode, frames, path, mode): the rows
# of scripts/make_torch_mip_golden.py.
MIP_ROWS = (
    ("tex_trilinear", "structured_tex+textures", "trilinear", "fused", 3,
     "tile", "texf_mip"),
    ("tex_anisotropic", "structured_tex+textures", "anisotropic", "fused",
     3, "tile", "texf_mip"),
    ("tex_deferred", "structured_tex+textures", "nearest", "deferred", 3,
     "tile", "vis"),
    ("textures_trilinear", "structured+textures", "trilinear", "fused", 3,
     "micro", "texf_mip"),
    ("textures_anisotropic", "structured+textures", "anisotropic", "fused",
     1, "micro", "texf_mip"),
    ("textures_deferred_trilinear", "structured+textures", "trilinear",
     "deferred", 1, "micro", "vis"),
)
MICRO_LAYERS = {
    "front": ("front_kernel",),
    "expand": ("expand_kernel",),
    "bin sort": ("bin_sort_",),
    "micro": ("micro_kernel",),
    "shading params": ("shading_params_kernel",),
}
# Kernels no main path's graph may hold since the bin sort and the vertex
# stage run on the card: torch's sort, searchsorted and running max (the
# bin sort's own kernels are named bin_sort_*).
TORCH_GLUE = ("sort", "searchsorted", "cummax")


def render_row(device, scene, frames, **options):
    """A fresh renderer of ``scene`` (a copy that animates from its start)
    and its first ``frames`` frames' uniforms, rendered through
    render_batch_device, as a numpy stack, and the launch counts."""
    from compute_renderer_torch import Renderer

    scene = scene_copy(scene)
    renderer = Renderer(scene.mesh, W, H, device=device,
                        **scene.renderer_options(), **options)
    reset_counts()
    batch = [scene.update(DT) for _ in range(frames)]
    imgs = renderer.render_batch_device(batch).cpu().numpy()
    require(not renderer.flush_overflow(), "overflow")
    return renderer, scene, batch, imgs, read_counts()


def phase_mip_main_paths(device, card, reports, scenes):
    """The mip and deferred rows through Scene -> Renderer ->
    render_batch_device against the JAX package's golden frames, with the
    per-mode launch counts; the fused == deferred contract on one frame;
    then the micro rows' batch slope and profile, beside the nearest
    +textures row of phase 10."""
    import numpy as np

    from compute_renderer_torch.backends import cuda

    golden = np.load(GOLDEN_MIP)
    renderers, first = {}, {}
    for row, key, tex_filter, tex_mode, frames, path, mode in MIP_ROWS:
        scene = scene_copy(scenes[key], texture_filter=tex_filter)
        require(cuda.resolve_path("auto", scene.total_tris) == path,
                f"{row} does not take the {path} path")
        renderer, scene, batch, imgs, launches = render_row(
            device, scene, frames, tex_mode=tex_mode)
        require_front_tables(f"mip {row}")
        ran = {k: v for k, v in launches.items() if v}
        print(f"[mip] {row} ({key}, {tex_filter}, {tex_mode}, {path} path, "
              f"{frames} frames): launches {ran} (the captures), no table "
              "copy")
        raster_name = ("raster_shade_micro" if path == "micro"
                       else "raster_shade_tiles")
        for name in (front_record(mode), record(raster_name, mode)):
            n = launches[name]
            require(n >= CAPTURE_LAUNCHES, f"{row}: the {name} kernel "
                    f"launched {n} times")
            if name != "front_end":  # the base front keeps its own count
                reports[name]["launches"] = (
                    reports[name].get("launches", 0) + n)
        check_texture_launches(f"mip {row}", launches, mode, tex_filter,
                               reports)
        other = ("raster_shade_tiles" if path == "micro"
                 else "raster_shade_micro")
        require(not any(launches[record(other, m)]
                        for m in ("base",) + MODE_KERNELS[other]),
                f"{row}: the {path} path launched {other}")
        if path == "micro":
            require(launches["expand_cells"] >= CAPTURE_LAUNCHES,
                    f"{row}: the expansion kernel did not run")
        note_bin_sort(row, path, launches, reports)
        require(golden[row].shape[0] == frames,
                f"{row}: {golden[row].shape[0]} golden frames")
        check_golden(f"mip {row}", imgs, golden[row])
        check_graph_equals_eager(f"mip {row}", renderer, batch, imgs)
        if path == "tile":
            note_tuner(f"structured_tex {row}", renderer)
            profile_flat_graph(f"mip {row}", renderer, scene)
        renderers[row] = (renderer, scene)
        first[row] = imgs[0]

    # The eager loop of these rows runs at 7-18 ms a frame: its slope is
    # taken over smaller batches.
    for row, tag in (("textures_trilinear", "structured +trilinear"),
                     ("textures_anisotropic", "structured +anisotropic"),
                     ("textures_deferred_trilinear",
                      "structured +deferred trilinear")):
        renderer, scene = renderers[row]
        compare_eager_graph(tag, renderer, scene, card, MICRO_LAYERS,
                            eager_sizes=SLOW_EAGER_BATCHES)

    # Fused == deferred on one frame: the deferred tail samples through
    # the fused tail's _sample_mip_px on the same mip rows. After the
    # profiles: with these renderers made (and one dropped) before them,
    # the +anisotropic row's profiled graph replay died with SIGSEGV in
    # CUDAGraph.replay in 7 runs of 11 (a fault under the profiler, not
    # isolated; none in the runs since the move).
    pairs = (("textures_trilinear", first["textures_deferred_trilinear"]),
             ("textures_anisotropic", None), ("tex_trilinear", None))
    for row, deferred in pairs:
        _, key, tex_filter, _, _, path, _ = next(r for r in MIP_ROWS
                                                 if r[0] == row)
        if deferred is None:
            scene = scene_copy(scenes[key], texture_filter=tex_filter)
            _, _, _, imgs, launches = render_row(device, scene, 1,
                                                 tex_mode="deferred")
            raster_name = ("raster_shade_micro" if path == "micro"
                           else "raster_shade_tiles")
            require(launches[record(raster_name, "vis")] >= 1,
                    f"{row} deferred: no vis launch")
            deferred = imgs[0]
        d = np.abs(first[row].astype(np.int32) - deferred.astype(np.int32))
        ndiff = int((d > 0).any(axis=-1).sum())
        print(f"[mip] {row}: fused vs deferred, {ndiff} px differ, max "
              f"{int(d.max())} LSB ({path} path)")
        limit = 0 if path == "micro" else 1
        require(int(d.max()) <= limit, f"{row}: fused and deferred differ "
                f"by {int(d.max())} LSB (limit {limit})")


# Phase 13's frame and cases (tests/test_torch_walks.py runs them too).
STRESS_W, STRESS_H = 256, 64
STRESS_CASES = ("duplicates", "nan_zero", "edges", "edges+mirage")
STRESS_EFFECTS = {"duplicates": [0.0] * 6, "edges": [0.0] * 6,
                  "nan_zero": [3.0, 0.3, 0.0, 0.0, 0.0, 0.4],  # voxelize
                  "edges+mirage": [4.0, 0.6, 0.05, 0.3, 1.0, 1.7]}


def stress_triangles(kind, span, rng):
    """(vertices (T, 3, 2), depths (T, 3), patches {column: rows}) of a
    stress case in screen space, and the rows whose depth plane is -0.0:
    - duplicates: one triangle over many cells, repeated 20 * span + 37
      times at one depth, with coplanar triangles of the same depth and a
      few nearer ones among the copies: equal keys straddle every span;
    - nan_zero: copies of a triangle at depth +0.0 among rows with NaN or
      infinite coefficients and rows whose depth plane is -0.0;
    - edges (and edges+mirage): triangles with integer corners whose edges
      run along the tile raster's sub-rectangle borders (multiples of 16)
      and through samples."""
    import numpy as np

    verts, depth, patches, neg_zero = [], [], {}, []

    def add(p, z):
        verts.append(p)
        depth.append([z] * 3)

    if kind == "duplicates":
        big = [(4.0, 2.0), (70.0, 2.0), (4.0, 60.0)]
        for i in range(20 * span + 37):
            add(big, 0.5)
            if i % 97 == 0:
                c = rng.uniform(8, 40, (3, 2)).round(1)
                add([tuple(v) for v in c], 0.5)
            if i % 131 == 0:
                c = rng.uniform(4, 48, (3, 2))
                add([tuple(v) for v in c], 0.25)
    elif kind == "nan_zero":
        big = [(2.0, 3.0), (60.0, 5.0), (30.0, 62.0)]
        bad = {0: float("nan"), 4: float("nan"), 8: float("nan"),
               30: float("nan"), 1: float("inf"), 5: float("-inf")}
        for i in range(3 * span + 11):
            add(big, 0.0)
            if i % 7 == 0:
                col = list(bad)[(i // 7) % len(bad)]
                patches.setdefault(col, []).append(len(verts))
                add(big, 0.0)
            if i % 11 == 0:
                neg_zero.append(len(verts))
                add(big, -0.0)
            if i % 13 == 0:
                add([tuple(v) for v in rng.uniform(0, 64, (3, 2))],
                    float(rng.choice([-0.25, 0.0, 0.125])))
        patches = {c: (r, bad[c]) for c, r in patches.items()}
    else:  # edges
        for k in range(1, 16):
            x = 16.0 * k
            for y in (0.0, 16.0, 32.0):
                add([(x, y), (x, y + 16.0), (x - 8.0, y + 8.0)], 0.3 + k / 64)
                add([(x, y), (x + 8.0, y + 8.0), (x, y + 16.0)], 0.4 - k / 64)
                add([(x - 16.0, y + 16.0), (x + 16.0, y + 16.0),
                     (x, y + 8.0)], 0.2 + y / 256)
        add([(0.0, 0.0), (32.0, 32.0), (0.0, 32.0)], 0.1)
        add([(32.0, 0.0), (96.0, 64.0), (32.0, 64.0)], 0.15)
        for _ in range(40):
            c = rng.integers(0, 17, (3, 2)) * np.array([16, 4])
            add([tuple(map(float, v)) for v in c], float(rng.uniform(0, 1)))
    return (np.asarray(verts, np.float32), np.asarray(depth, np.float32),
            patches, neg_zero)


def stress_lists(verts, tile_h, tile_w, width, height):
    """Each triangle listed in every tile (or cell) its bounding box, grown
    by 2 pixels for the mirage warp, touches, in ascending triangle order:
    (pair_tri sorted by row-major tile id, seg_start, seg_count) as numpy
    int32."""
    import numpy as np

    ntx, nty = width // tile_w, height // tile_h
    lo = np.floor(verts.min(1) - 2.0).astype(np.int64)
    hi = np.ceil(verts.max(1) + 2.0).astype(np.int64)
    pairs = []
    for t in range(verts.shape[0]):
        x0, x1 = max(lo[t, 0] // tile_w, 0), min(hi[t, 0] // tile_w, ntx - 1)
        y0, y1 = max(lo[t, 1] // tile_h, 0), min(hi[t, 1] // tile_h, nty - 1)
        for ty in range(y0, y1 + 1):
            for tx in range(x0, x1 + 1):
                pairs.append((ty * ntx + tx, t))
    pairs.sort()
    tiles = np.array([p[0] for p in pairs], np.int64)
    counts = np.bincount(tiles, minlength=ntx * nty).astype(np.int32)
    starts = (np.cumsum(counts) - counts).astype(np.int32)
    return np.array([p[1] for p in pairs], np.int32), starts, counts


def stress_inputs(kind, device, span, tile=(16, 256)):
    """Card (or CPU) tensors of a phase-13 case, built directly (no front
    end), at STRESS_W x STRESS_H: "tables" {mode: (T, R) f32} (the base
    columns from the screen corners, patched with NaN / inf coefficients
    and -0.0 depth planes, then random mode columns), "tile" {layout:
    (pair data, seg_start, seg_count)} at ``tile``, "micro" (pair_tri padded
    past the end, seg_start, seg_count, tile_count), "params", "lights"."""
    import numpy as np
    import torch

    from compute_renderer_torch.backends import raster

    rng = np.random.default_rng(2024 + STRESS_CASES.index(kind))
    verts, depth, patches, neg_zero = stress_triangles(kind, span, rng)
    T = verts.shape[0]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))
    screen = tuple((t(verts[:, k, 0]), t(verts[:, k, 1]), t(depth[:, k]),
                    t(np.ones(T))) for k in range(3))
    unit = rng.standard_normal((3, 3, T)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=1, keepdims=True)
    world = rng.uniform(-2, 2, (3, 3, T)).astype(np.float32)
    table = torch.stack(raster.tri_table_columns(
        screen, tuple(tuple(t(unit[k, c]) for c in range(3))
                      for k in range(3)),
        tuple(tuple(t(world[k, c]) for c in range(3)) for k in range(3))),
        dim=1)
    for col, (rows, value) in patches.items():
        table[rows, col] = value
    table[neg_zero, 9:12] = -0.0
    tables = {}
    for mode, width in raster.MODE_WIDTHS.items():
        extra = t(rng.uniform(0, 1, (T, width - raster.TRI_TABLE_WIDTH)))
        tables[mode] = torch.cat([table, extra], 1).to(device)

    i32 = lambda a: torch.from_numpy(np.asarray(a, np.int32)).to(device)
    flat, starts, counts = stress_lists(verts, *tile, STRESS_W, STRESS_H)
    dense = np.zeros((counts.size, max(int(counts.max()), 1)), np.int32)
    for tile, (s, n) in enumerate(zip(starts, counts)):
        dense[tile, :n] = flat[s:s + n]
    tile = {"flat": (i32(flat), i32(starts), i32(counts)),
            "dense": (i32(dense), i32(starts), i32(counts))}
    # Micro: 8x8 cells, row-major ids (16 to an 8x128 tile).
    cell_tri, cstarts, ccounts = stress_lists(verts, 8, 8, STRESS_W,
                                              STRESS_H)
    padded = np.concatenate([cell_tri, np.zeros(3 * span + 5, np.int32)])
    micro_bins = (i32(padded), i32(cstarts), i32(ccounts),
                  i32(ccounts.reshape(-1, 16).sum(1)))
    effect = torch.tensor(STRESS_EFFECTS[kind], dtype=torch.float32,
                          device=device)
    lights = (torch.tensor([[0.0, 0.0, 5.0], [-5.0, 3.0, 0.0]], device=device),
              torch.tensor([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5]], device=device),
              torch.tensor([1.0, 0.5], device=device))
    vpos = torch.tensor([0.1, 0.05, 3.0], device=device)
    params, light_rows = raster.shading_inputs(effect, vpos, *lights)
    return {"tables": tables, "tile": tile, "micro": micro_bins,
            "effect": effect, "vpos": vpos, "lights": lights,
            "params": params, "light_rows": light_rows,
            "densest": int(ccounts.max()), "longest": int(counts.max())}


def phase_stress(device, reports):
    """Phase 13: every mode of both rasters against its twin on the stress
    cases, built directly on the card, the tile raster at each tile shape
    of ``cuda.TILE_CANDIDATES`` (the flat layout over its span list):
    keys, ids, pair indices and G-buffers bitwise, RGBA within 1 LSB; the
    micro kernel's count of the samples it tested equal to the twin's."""
    import torch

    from compute_renderer_torch.backends import binning, cuda, micro, raster

    for kind in STRESS_CASES:
        tiled = {tile: stress_inputs(kind, device, micro.SPAN, tile=tile)
                 for tile in cuda.TILE_CANDIDATES}
        x = tiled[16, 256]
        kw = dict(height_padded=STRESS_H, width_padded=STRESS_W)
        for mode in ("base",) + MODES + NEW_MODES:
            table = x["tables"][mode]
            for (th, tw), xt in tiled.items():
                for layout, (data, starts, counts) in xt["tile"].items():
                    rk, kk = raster.raster_shade_tiles(
                        xt["tables"][mode], data, starts, counts,
                        xt["effect"], xt["vpos"], *xt["lights"], tile_h=th,
                        tile_w=tw, layout=layout, mode=mode, **kw)
                    rp, kp = raster.raster_shade_tiles_plain(
                        xt["tables"][mode], data, starts, counts,
                        xt["params"], xt["light_rows"], tile_h=th,
                        tile_w=tw, layout=layout, mode=mode, **kw)
                    torch.cuda.synchronize()
                    diff, covered = compare_outputs(
                        f"stress {kind} raster {mode} {th}x{tw} {layout}",
                        mode, rk, kk, rp, kp)
                    rep = reports[record("raster_shade_tiles", mode)]
                    rep["max_abs_err"] = max(rep.get("max_abs_err", 0.0),
                                             diff)
            pair_tri, starts, counts, tile_count = x["micro"]
            acc = torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                              device=device)
            rk, kk = micro.raster_shade_micro(
                table, pair_tri, starts, counts, tile_count, x["effect"],
                x["vpos"], *x["lights"], mode=mode, acc=acc, **kw)
            rp, kp = micro.raster_shade_micro_plain(
                table, pair_tri, starts, counts, x["params"],
                x["light_rows"], mode=mode, **kw)
            torch.cuda.synchronize()
            diff, covered_m = compare_outputs(
                f"stress {kind} micro {mode}", mode, rk, kk, rp, kp)
            samples = int(micro.samples_tested_plain(
                table, pair_tri, starts, counts, x["params"],
                width_padded=STRESS_W))
            require(int(acc[4]) == samples,
                    f"stress {kind} micro {mode}: the kernel counts "
                    f"{int(acc[4])} samples tested, the twin {samples}")
            rep = reports[record("raster_shade_micro", mode)]
            rep["max_abs_err"] = max(rep.get("max_abs_err", 0.0), diff)
        lists = []
        for (th, tw), xt in tiled.items():
            flat, _, flat_counts = xt["tile"]["flat"]
            extra = int(binning.span_list_plain(flat_counts,
                                                flat.shape[0])[0])
            lists.append(f"{th}x{tw} {xt['longest']} ({extra} spans past "
                         f"the first)")
        lists = ", ".join(lists)
        print(f"[stress] {kind}: T={x['tables']['base'].shape[0]}, every "
              f"mode of both rasters equals its twin (keys, ids, G-buffers "
              f"bitwise; RGBA within 1 LSB); longest tile list "
              f"{lists}, densest cell {x['densest']} pairs (span "
              f"{micro.SPAN}), covered {covered} (tile) / {covered_m} "
              f"(micro) px; micro samples tested {samples} as the twin's "
              f"of {int(counts.sum())} pairs")
    stress_texture(device, reports)


def stress_texture(device, reports):
    """Phase 13's texture case, built on the card at STRESS_W x STRESS_H:
    a texf and a texf_mip G-buffer over four textures of odd and unit
    sizes, uv from -3.5 to 4.5 (negative and past 1), NaN uv (and a NaN
    lod) in the uncovered and untextured pixels; both fused tails in
    every filter (both pools) against their plain versions, RGBA within
    1 LSB."""
    import numpy as np
    import torch

    from compute_renderer_torch.backends import texture
    from compute_renderer_torch.io.textures import (
        pack_pool_u8, trilinear_tex_arrays,
    )

    rng = np.random.default_rng(2031)
    sizes = ((5, 3), (1, 7), (6, 6), (16, 16))
    offsets = np.cumsum([0] + [w * h for w, h in sizes])
    table = np.array([[o, w, h] for o, (w, h) in zip(offsets, sizes)],
                     np.int32)
    texels = (rng.integers(0, 256, (offsets[-1], 3))
              / np.float32(255.0)).astype(np.float32)
    pool, mips = trilinear_tex_arrays(texels, table)
    h, w, nl = STRESS_H, STRESS_W, 2
    key = rng.integers(0, 2**31, (h, w)).astype(np.uint32)
    clear = rng.random((h, w)) < 0.15
    key[clear] = 0xFFFFFFFF
    slot = rng.integers(-1, len(sizes), (h, w))
    masked = clear | (slot < 0)
    uv = rng.uniform(-3.5, 4.5, (2, h, w)).astype(np.float32)
    uv[:, masked] = np.nan
    kd = rng.uniform(0, 1, (3, h, w))
    terms = rng.uniform(0, 1, (2 * nl, h, w))
    rows = np.where((slot >= 0)[None],
                    table[np.maximum(slot, 0)].transpose(2, 0, 1), 0)
    g = np.concatenate([uv, kd, rows, terms]).astype(np.float32)
    gm = np.concatenate([
        uv, kd, slot[None], rng.uniform(0, mips.shape[1] - 1, (1, h, w)),
        rng.uniform(-0.05, 0.05, (2, h, w)),
        rng.choice([0.0, 0.5, 0.75], (1, h, w)), terms]).astype(np.float32)
    gm[6, masked] = np.nan
    dev = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    keyd = dev(key.view(np.int32))
    lights = (dev(np.array([[1.0, 0.9, 0.8], [0.3, 0.4, 0.5]], np.float32)),
              dev(np.array([1.0, 0.5], np.float32)))
    for tex_filter in FLAT_FILTERS:
        for packed in (None, dev(pack_pool_u8(texels))):
            args = (dev(g), keyd, dev(texels), *lights)
            kw = dict(tex_filter=tex_filter, texels_packed=packed)
            compare_rgba(f"stress texture_tail {tex_filter}"
                         f"{'' if packed is None else ' packed pool'}",
                         texture.texture_tail(*args, **kw),
                         texture.texture_tail_plain(*args, **kw),
                         reports["texture_tail"])
    for tex_filter in MIP_FILTERS:
        args = (dev(gm), keyd, dev(pool), dev(mips), *lights)
        compare_rgba(f"stress texture_tail_mip {tex_filter}",
                     texture.texture_tail_mip(*args, tex_filter=tex_filter),
                     texture.texture_tail_mip_plain(
                         *args, tex_filter=tex_filter),
                     reports["texture_tail_mip"])


def phase_graph_summary(card):
    """Phase 14: every main-path row's eager loop against its replayed
    graph, as phases 5, 6, 10 and 12 measured them in this run; the tile
    tuner's pick and timings on each tile-path row; and ``bench_torch.py``
    run once, its JSON line checked and printed."""
    print("[graph] row: slope ms/frame graph | eager (eager batches); busy "
          "ms/frame graph | eager; kernels a frame graph | eager; idle "
          "share graph | eager; host calls a frame graph | eager")
    for tag, row in GRAPH_ROWS.items():
        g, e = row["graph"], row["eager"]
        print(f"[graph] {tag}: {g['slope_ms']:.6f} | {e['slope_ms']:.6f} "
              f"({row['eager_sizes'][0]}->{row['eager_sizes'][1]}); "
              f"{g['busy_ms']:.6f} | {e['busy_ms']:.6f}; {g['kernels']:.1f} "
              f"| {e['kernels']:.1f}; {g['idle']:.4f} | {e['idle']:.4f}; "
              f"{g['host_calls']} | {e['host_calls']} ; card: {card}")
    for tag, (shape, timings) in TUNED_ROWS.items():
        print(f"[tune] {tag}: {shape[0]}x{shape[1]} of {timings} (ms)")
    for tag, split in SORT_PROFILES.items():
        print(f"[sort] {tag}: " + "; ".join(
            f"{short_name(k)} {ms:.6f} ms x{c:g}"
            for k, (ms, c) in split.items()) + f" ; card: {card}")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable,
                           os.path.join(ROOT, "bench_torch.py")], cwd=ROOT,
                          capture_output=True, text=True, timeout=600)
    require(proc.returncode == 0 and proc.stdout.strip(),
            f"bench_torch.py failed ({proc.returncode}): "
            f"{proc.stderr[-2000:]}")
    line = proc.stdout.strip().splitlines()[-1]
    result = json.loads(line)
    require("cuda backend" in result["metric"]
            and result["extra"]["card"] and result["value"] > 0,
            f"bench_torch.py printed {line}")
    print(f"[bench_torch] {time.perf_counter() - t0:.1f} s: {line}")


GOLDEN_CMP = os.path.join(ROOT, "tests", "golden_data",
                          "torch_comparators_1024x768.npz")
# The comparator phase's scenes: bench/suite.py rows (their cameras).
SUITE_ROWS = {"exterior": 2, "suzanne": 4, "san_miguel_small": 8}
COMPARATOR_CHUNKS = (16, 64, 256)
# Frames each suite row records (after the unrecorded first batch or
# frame): the engine rows in batches, the comparators one at a time.
SUITE_ENGINE_FRAMES, SUITE_BATCH = 64, 16
SUITE_COMPARATOR_FRAMES = 1
# The engine rows again frame by frame (batch 1: a checked, fenced frame,
# the per-frame latency).
SUITE_LATENCY_FRAMES = 32
# The big comparator rows (~0.8-1M triangles) after the first run only
# while the script is younger than this (seconds).
SUITE_BIG_BUDGET_S = 720.0
T_START = time.perf_counter()


def read_png(path):
    """(H, W, 4) u8 of an 8-bit RGBA PNG file (``decode_png``)."""
    with open(path, "rb") as fh:
        return decode_png(fh.read(), path)


def decode_png(data, name="PNG"):
    """(H, W, 4) u8 of the bytes of an 8-bit RGBA PNG of filter-0 rows
    (what the port's minimal writer emits: this machine has no Pillow),
    with zlib alone."""
    import struct
    import zlib

    import numpy as np

    require(data[:8] == b"\x89PNG\r\n\x1a\n", f"{name}: not a PNG")
    pos, idat, size = 8, b"", None
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        require(crc == zlib.crc32(tag + body) & 0xFFFFFFFF,
                f"{name}: bad CRC in {tag}")
        if tag == b"IHDR":
            size = struct.unpack(">II", body[:8])
            require(body[8:10] == b"\x08\x06", f"{name}: not 8-bit RGBA")
        elif tag == b"IDAT":
            idat += body
        pos += 12 + n
    w, h = size
    rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 4 * w)
    require(bool((rows[:, 0] == 0).all()), f"{name}: filtered rows")
    return rows[:, 1:].reshape(h, w, 4)


def suite_scene(name):
    """(config, Scene) of a bench/suite.py row, at W x H."""
    from compute_renderer_torch import Scene
    from compute_renderer_torch.bench.suite import benchmark_scene_configs

    cfg = benchmark_scene_configs()[SUITE_ROWS[name]]
    return cfg, Scene.from_config(cfg, W, H)


def timed_frames(renderer, uniforms, frames=3):
    """(last frame, ms/frame): one checked frame first (the warm-up), then
    ``frames`` render() calls, each read back to the host (the end of a
    comparator frame), on the host clock."""
    import torch

    renderer.render(uniforms)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(frames):
        img = renderer.render(uniforms)
    return img, (time.perf_counter() - t0) / frames * 1e3


def pixels_off(a, b):
    """(pixels differing, pixels more than 2 LSB off, max LSB)."""
    import numpy as np

    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    return (int((d > 0).any(axis=-1).sum()), int((d > 2).any(axis=-1).sum()),
            int(d.max()))


def phase_comparators(device, card, scenes):
    """Phase 15: the comparator backends at 1024x768 on the card. The
    xla and wgpu-faithful frames of Suzanne and Exterior at their suite
    cameras, and the xla frame of structured_tex +textures, against
    tests/golden_data/torch_comparators_1024x768.npz (the JAX package's;
    the pixel contract, the xla winner ids counted); the xla frame
    against the engine's on Suzanne, Exterior, san_miguel_small and
    structured_tex +textures (the pixel contract; the counts printed);
    ms/frame of each; and xla at each of COMPARATOR_CHUNKS on three
    scenes, the frames bitwise equal, with ms/frame and peak memory."""
    import numpy as np
    import torch

    from compute_renderer_torch import Renderer
    from compute_renderer_torch.backends import get_backend

    golden = np.load(GOLDEN_CMP)
    budget = max(2, H * W // 500)
    rows = {name: suite_scene(name)[1] for name in SUITE_ROWS}
    rows["structured_tex"] = scene_copy(scenes["structured_tex+textures"])
    uniforms = {name: scene.update(DT) for name, scene in rows.items()}
    for name, backend, gold in (
            ("suzanne", "xla", "suzanne_xla"),
            ("suzanne", "wgpu-faithful", "suzanne_wgpu"),
            ("exterior", "xla", "exterior_xla"),
            ("exterior", "wgpu-faithful", "exterior_wgpu"),
            ("structured_tex", "xla", "structured_tex_xla"),
            ("san_miguel_small", "xla", None)):
        scene, u = rows[name], uniforms[name]
        tag = f"cmp {name} {backend}"
        r = Renderer(scene.mesh, W, H, backend=backend, device=device,
                     **scene.renderer_options())
        reset_counts()
        img, ms = timed_frames(r, u)
        counts = {k: v for k, v in read_counts().items() if v}
        require(not counts, f"{tag}: launched engine kernels: {counts}")
        note = ""
        if gold is not None:
            check_golden(tag, [img], [golden[gold]])
        if backend == "xla":
            out = get_backend("xla").render_frame(
                r.positions, r.normals, r.uvs, r.tri,
                *(torch.as_tensor(np.asarray(a), device=device) for a in (
                    u.view_proj, u.view_position, u.light_world_pos,
                    u.light_color, u.light_intensity, u.effect)),
                width=W, height=H, return_tri=True, **r.ext)
            np.testing.assert_array_equal(out[0].cpu().numpy(), img)
            if gold is not None:
                ids = out[2].cpu().numpy()
                n_ids = int((ids != golden[gold + "_tri"]).sum())
                require(n_ids <= budget, f"{tag}: {n_ids} winner ids differ "
                        f"from the golden ids (budget {budget})")
                note = f"; {n_ids} winner ids differ from the golden's"
            engine = Renderer(scene.mesh, W, H, device=device,
                              **scene.renderer_options()).render(u)
            ndiff, nbad, dmax = pixels_off(img, engine)
            require(nbad <= budget, f"{tag}: {nbad} px more than 2 LSB off "
                    f"the engine's frame (budget {budget})")
            note += (f"; against the engine: {ndiff} px differ, {nbad} by "
                     f"more than 2 LSB (max {dmax} LSB)"
                     + (", bitwise" if ndiff == 0 else ""))
        print(f"[{tag}] T={scene.total_tris}: {ms:.3f} ms/frame (host clock "
              f"over 3 render() frames){note}; card: {card}")
        del r

    for name in ("exterior", "san_miguel_small", "structured_tex"):
        scene, u = rows[name], uniforms[name]
        ref = None
        for chunk in COMPARATOR_CHUNKS:
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(device)
            r = Renderer(scene.mesh, W, H, backend="xla", device=device,
                         chunk=chunk, **scene.renderer_options())
            img, ms = timed_frames(r, u)
            peak = torch.cuda.max_memory_allocated(device)
            if ref is None:
                ref = img
            require(np.array_equal(img, ref), f"xla {name}: chunk {chunk} "
                    "changed the frame")
            print(f"[cmp-chunk] xla {name} chunk {chunk}: {ms:.3f} ms/frame, "
                  f"peak memory {peak} B, frame bitwise equal to chunk "
                  f"{COMPARATOR_CHUNKS[0]}'s; card: {card}")
            del r


def run_cli(args, tag):
    """``python3 -m compute_renderer_torch.cli`` in a subprocess, on the
    card; it must exit 0."""
    proc = subprocess.run([sys.executable, "-m", "compute_renderer_torch.cli",
                           *args], cwd=ROOT, capture_output=True, text=True,
                          timeout=600)
    require(proc.returncode == 0, f"{tag}: exit {proc.returncode}: "
            f"{proc.stderr[-3000:]}")


def phase_cli_suite(device, card):
    """Phase 16: the CLI as a subprocess (three orbit frames at 1024x768
    and one wave-effect frame, the PNGs decoded with zlib), then the 21
    rows of bench/suite.py through run_suite at 1024x768, one call a
    row: the engine rows in batches of SUITE_BATCH up to
    SUITE_ENGINE_FRAMES recorded frames, the comparators frame by frame
    up to SUITE_COMPARATOR_FRAMES; each row's JSON (with its launches and
    peak memory) printed; no overflow and at least one frame in every
    row; the engine rows launched their path's kernels, the comparators
    none."""
    import numpy as np

    from compute_renderer_torch.bench.suite import (
        benchmark_scene_configs,
    )

    out_dir = os.path.join(ROOT, "build", "cli")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    t0 = time.perf_counter()
    run_cli(["--width", str(W), "--height", str(H), "--camera-mode",
             "orbit", "--frames", "3", "--output",
             os.path.join(out_dir, "f.png")], "cli orbit")
    t_orbit = time.perf_counter() - t0
    t0 = time.perf_counter()
    run_cli(["--width", str(W), "--height", str(H), "--frames", "1",
             "--output", os.path.join(out_dir, "wave.png"), "effect",
             "--effect", "wave"], "cli wave")
    t_wave = time.perf_counter() - t0
    for name in ("f_0000.png", "f_0001.png", "f_0002.png", "wave.png"):
        img = read_png(os.path.join(out_dir, name))
        covered = int((img != np.array([0, 0, 255, 255], np.uint8))
                      .any(axis=-1).sum())
        require(img.shape == (H, W, 4), f"cli {name}: shape {img.shape}")
        print(f"[cli] {name}: {img.shape}, {covered} covered px")
    print(f"[cli] orbit 3 frames {t_orbit:.1f} s, wave 1 frame {t_wave:.1f} s "
          "(each a fresh process: start, load, kernels loaded, frames)")

    for i, cfg in enumerate(benchmark_scene_configs()):
        engine = cfg.normalized_backend() == "cuda"
        big = not engine and "small" not in cfg.model_path and (
            "San_Miguel" in cfg.model_path or "vokselia" in cfg.model_path)
        age = time.perf_counter() - T_START
        if big and i != 1 and age > SUITE_BIG_BUDGET_S:
            print(f"[suite] row {i} {cfg.scene_name()}: left out, the script "
                  f"is {age:.0f} s old (budget {SUITE_BIG_BUDGET_S:.0f} s "
                  "for the big comparator rows)")
            continue
        if engine:
            suite_row(i, engine, SUITE_BATCH, SUITE_ENGINE_FRAMES, device,
                      card)
            suite_row(i, engine, 1, SUITE_LATENCY_FRAMES, device, card)
        else:
            suite_row(i, engine, SUITE_BATCH, SUITE_COMPARATOR_FRAMES,
                      device, card)


def suite_row(i, engine, batch, frames, device, card):
    """Row ``i`` of the suite through ``run_suite`` (which runs the
    comparators at batch 1 whatever ``batch`` says), its checks, and its
    JSON line."""
    import torch

    from compute_renderer_torch.bench.suite import run_suite

    reset_counts()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    (row,) = run_suite(width=W, height=H, offset=i, limit=1,
                       duration_secs=60.0, max_frames=frames, batch=batch,
                       device=device)
    secs = time.perf_counter() - t0
    counts = {k: v for k, v in read_counts().items() if v}
    require(row["frames"] >= 1 and row["overflow"] is False,
            f"suite row {i}: frames {row['frames']}, overflow "
            f"{row['overflow']}")
    if engine:
        micro = any(k.startswith("raster_shade_micro") for k in counts)
        tile = any(k.startswith("raster_shade_tiles") for k in counts)
        require(any(k.startswith("front_end") for k in counts)
                and (tile or micro)
                and (not micro or counts.get("expand_cells", 0) > 0),
                f"suite row {i}: the engine's kernels did not launch "
                f"({counts})")
    else:
        require(not counts, f"suite row {i}: a comparator launched engine "
                f"kernels ({counts})")
    keep = ("scene", "backend", "num_triangles", "frames", "batch",
            "ms_per_frame", "avg_fps", "min_fps", "max_fps",
            "fps_5_percent_low", "fps_1_percent_low", "tail_source",
            "overflow", "dispatch_overhead_ms")
    line = {k: row[k] for k in keep}
    line.update(row=i, seconds=round(secs, 3),
                peak_memory_bytes=torch.cuda.max_memory_allocated(device),
                launches=counts, card=card)
    print(f"[suite] {json.dumps(line)}")


# Phase 17: the multi-device decompositions (compute_renderer_torch/
# parallel/) by ranks that share the card through a gloo group.
PAR_RANKS = 4
PAR_NS = (1, 2, 4)  # group sizes timed: sub-groups of the first n ranks
PAR_TIMED_CALLS = 5  # timed frames per decomposition and group size
PAR_FRAMES = 16  # frame-parallel frames
PAR_TIMEOUT_S = 300.0  # each collective's limit (group.launch)
PAR_WAVE = (0.4, 3.0, 2.0)  # the frame-parallel Suzanne's wave effect


def par_digest(*arrays):
    """One hash of arrays' bytes: what a rank other than 0 returns in
    place of its frame."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(a.tobytes())
    return h.hexdigest()


def par_counts():
    return {name: launch_count(w) for name, w in counters().items()}


def parallel_rank(rank, world, meshes, plan):
    """Phase 17 on one rank: every case of ``plan`` on the sub-group of
    its first n ranks, for each n of the case (the other ranks wait at
    the fences). Returns {"frames": rank 0's frames, digests elsewhere,
    "counts": launch counts of the case's first call, "stats": the
    retrying entry's capacities, "ms": host ms a frame over the timed
    calls (fenced), "replays": graph replays of the frame-parallel
    renderers}."""
    import torch
    import torch.distributed as dist

    from compute_renderer_torch import tracing
    from compute_renderer_torch.backends import cuda
    from compute_renderer_torch.engine.renderer import Renderer
    from compute_renderer_torch.parallel import (
        make_2d, make_mesh, mesh_from_tensors, rank_device,
        render_frame_sharded, render_frames, render_frames_2d,
        render_sharded,
    )

    device = rank_device("cuda", rank)
    groups = {n: make_mesh(n) for n in sorted({n for c in plan
                                               for n in c["ns"]})}
    layout = (make_2d(2, world // 2)
              if any(c["kind"] == "frames2d" for c in plan) else None)
    mesh = {k: mesh_from_tensors(v) for k, v in meshes.items()}
    out = {"frames": {}, "counts": {}, "stats": {}, "ms": {}, "replays": {}}

    def fence():
        torch.cuda.synchronize(device)
        dist.barrier()

    def keep(tag, *arrays):
        out["frames"][tag] = arrays if rank == 0 else par_digest(*arrays)

    renderers = {}
    for case in plan:
        for n in case["ns"]:
            tag = f"{case['name']}_n{n}"
            member = rank < n
            fence()
            if case["kind"] == "sharded":
                u = case["uniforms"]
                lights = (u.light_world_pos, u.light_color,
                          u.light_intensity)
                opts = case["options"]
                if member:
                    reset_counts()
                    stats = {}
                    rgba, keys = render_sharded(
                        mesh[case["mesh"]], u, lights, u.effect, W, H,
                        group=groups[n], device=device, stats=stats,
                        **opts)
                    out["counts"][tag] = par_counts()
                    out["stats"][tag] = stats
                    keep(tag, rgba, keys)
                if not case["timed"]:
                    continue
                if member:
                    tex = {k: opts[k] for k in ("tex_filter", "tex_mode")
                           if k in opts}
                    args, ext = cuda.frame_tensors(
                        mesh[case["mesh"]], u, lights, u.effect, device,
                        **tex)
                    caps = {k: stats[k] for k in ("path", "pair_cap",
                                                  "tile_cap", "bucket_cap")}

                    def frame():
                        return render_frame_sharded(
                            *args, width=W, height=H, group=groups[n],
                            **caps, **ext)

                    frame()
                fence()
                t0 = time.perf_counter()
                if member:
                    for _ in range(PAR_TIMED_CALLS):
                        frame()
                fence()
                out["ms"][tag] = ((time.perf_counter() - t0) * 1e3
                                  / PAR_TIMED_CALLS)
            else:
                seq = case["frames"]
                key = (case["name"], n)
                if case["kind"] == "frames2d":
                    r = Renderer(mesh[case["mesh"]], W, H, device=device,
                                 **case["options"])
                    reset_counts()
                    frames = render_frames_2d(r, seq, layout)
                    out["counts"][tag] = par_counts()
                    keep(tag, frames)
                    continue
                if member:
                    # A fresh renderer a group size: its capture counts.
                    r = renderers[key] = Renderer(
                        mesh[case["mesh"]], W, H, device=device,
                        **case["options"])
                    reset_counts()
                    frames = render_frames(r, seq, group=groups[n])
                    out["counts"][tag] = par_counts()
                    keep(tag, frames)
                fence()
                t0 = time.perf_counter()
                if member:
                    render_frames(renderers[key], seq, group=groups[n])
                fence()
                out["ms"][tag] = ((time.perf_counter() - t0) * 1e3
                                  / len(seq))
                if member:
                    # Replays since the renderer's reset_counts().
                    out["replays"][tag] = (tracing.count("replays"),
                                           len(renderers[key]._graphs))
    return out


def par_reference(device, scene_mesh, uniforms, **options):
    """The single-device frame and keys: a ``Renderer`` (tile shape not
    tuned: the stripes render at the default (16, 256)) after a checked
    frame, replaying its graph."""
    from compute_renderer_torch import Renderer

    r = Renderer(scene_mesh, W, H, device=device, tile_autotune=False,
                 **options)
    r.render(uniforms)
    rgba, key, overflow = r.render_device(uniforms)
    require(not overflow.any(), "overflow in a single-device reference")
    return rgba.cpu().numpy(), key.cpu().numpy()


def par_check_counts(tag, counts, path):
    need = (("front_end", "bin_tiles_dense", "shading_params",
             "raster_shade_tiles") if path == "tile" else
            ("front_end", "expand_cells", "shading_params",
             "raster_shade_micro") + (("bin_sort",) if path == "micro"
                                      else ()))
    for name in need:
        require(counts.get(name, 0) > 0,
                f"{tag}: the {name} kernel was not launched ({counts})")


def phase_parallel(device, card, scenes):
    """Phase 17: ``compute_renderer_torch.parallel`` on ``PAR_RANKS``
    ranks that share the card (backend "gloo", chosen explicitly; rank r
    on cuda:0): tile stripes of Suzanne (plain and mirage) at n = 2 and 4,
    micro stripes and sort-middle of San Miguel at n = 4, structured
    +textures (texf) on micro stripes and structured +deferred trilinear
    (vis + mip) on sort-middle at n = 4, 16 frame-parallel frames of
    Suzanne (wave) and of San Miguel at n = 4, the 2 x 2 frames x stripes
    layout on Suzanne; each frame bitwise equal to the single-device
    renderer's (keys too), every rank's the same; the two textured rows
    within the golden pixel contract; each rank's launch counts show the
    path's kernels; the frame-parallel ranks replayed their own graphs.
    Then sort-middle of San Miguel in a world-size-1 NCCL group (the NCCL
    calls on the card), bitwise as well, with its bucket_cap and gathered
    table size; ms/frame of every decomposition at n = 1, 2, 4 (host
    clock, fenced) and ``stage_timings_sortmiddle`` at n = 4, printed with
    the card line: ranks share one card, so these are not scaling
    numbers."""
    import numpy as np

    from compute_renderer_torch.backends import raster
    from compute_renderer_torch.bench.profiling import (
        stage_timings_sortmiddle,
    )
    from compute_renderer_torch.core.effects import Effect, WaveDirection
    from compute_renderer_torch.parallel import launch, mesh_tensors

    t_phase = time.perf_counter()
    suz = bench_scene()
    mirage = bench_scene(effect=Effect.mirage(0.6, 0.7, 0.3))
    wave = bench_scene(effect=Effect.wave(*PAR_WAVE,
                                          WaveDirection.VERTICAL))
    sm = bench_scene(SAN_MIGUEL, eye=SAN_MIGUEL_EYE)
    tex = scene_copy(scenes["structured+textures"])
    tri = scene_copy(scenes["structured+textures"],
                     texture_filter="trilinear")
    meshes = {"suzanne": suz.mesh, "san_miguel": sm.mesh,
              "structured": tex.mesh}
    u_suz, u_mir, u_sm = suz.update(DT), mirage.update(DT), sm.update(DT)
    u_tex, u_tri = tex.update(DT), tri.update(DT)
    wave_seq = [wave.update(DT) for _ in range(PAR_FRAMES)]
    sm_seq = [sm.update(DT) for _ in range(PAR_FRAMES)]

    def sharded(name, mesh, u, ns, timed, **options):
        return dict(kind="sharded", name=name, mesh=mesh, uniforms=u, ns=ns,
                    timed=timed, options=options)

    plan = [
        sharded("tile_suzanne", "suzanne", u_suz, PAR_NS, True,
                path="tile"),
        sharded("tile_suzanne_mirage", "suzanne", u_mir, (2, 4), False,
                path="tile"),
        sharded("micro_san_miguel", "san_miguel", u_sm, PAR_NS, True,
                path="micro"),
        sharded("sortmiddle_san_miguel", "san_miguel", u_sm, PAR_NS, True,
                path="sortmiddle"),
        sharded("micro_structured_texf", "structured", u_tex, (4,), False,
                path="micro"),
        sharded("sortmiddle_structured_deferred_trilinear", "structured",
                u_tri, (4,), False, path="sortmiddle",
                tex_filter="trilinear", tex_mode="deferred"),
        dict(kind="frames", name="frames_suzanne_wave", mesh="suzanne",
             frames=wave_seq, ns=PAR_NS, options=dict(tile_autotune=False)),
        dict(kind="frames", name="frames_san_miguel", mesh="san_miguel",
             frames=sm_seq, ns=PAR_NS, options={}),
        dict(kind="frames2d", name="frames2d_suzanne_wave", mesh="suzanne",
             frames=wave_seq[:4], ns=(PAR_RANKS,),
             options=dict(path="micro")),
    ]
    tensors = {k: mesh_tensors(m) for k, m in meshes.items()}
    t0 = time.perf_counter()
    results = launch(parallel_rank, PAR_RANKS, (tensors, plan),
                     backend="gloo", device="cuda", timeout=PAR_TIMEOUT_S)
    t_gloo = time.perf_counter() - t0
    t0 = time.perf_counter()
    nccl = launch(parallel_rank, 1, (
        {"san_miguel": tensors["san_miguel"]},
        [sharded("sortmiddle_san_miguel_nccl", "san_miguel", u_sm, (1,),
                 True, path="sortmiddle")]),
        backend="nccl", device="cuda", timeout=PAR_TIMEOUT_S)[0]
    t_nccl = time.perf_counter() - t0
    print(f"[parallel] {PAR_RANKS} gloo ranks on cuda:0: {t_gloo:.1f} s; "
          f"1 NCCL rank on cuda:0: {t_nccl:.1f} s (spawn, set-up and the "
          "runs)")

    # The single-device references, each case's frame and keys.
    refs = {
        "tile_suzanne": par_reference(device, suz.mesh, u_suz, path="tile"),
        "tile_suzanne_mirage": par_reference(device, suz.mesh, u_mir,
                                             path="tile"),
        "micro_san_miguel": par_reference(device, sm.mesh, u_sm,
                                          path="micro"),
        "micro_structured_texf": par_reference(device, tex.mesh, u_tex,
                                               path="micro"),
        "sortmiddle_structured_deferred_trilinear": par_reference(
            device, tex.mesh, u_tri, path="micro", tex_filter="trilinear",
            tex_mode="deferred"),
    }
    refs["sortmiddle_san_miguel"] = refs["micro_san_miguel"]
    refs["sortmiddle_san_miguel_nccl"] = refs["micro_san_miguel"]
    golden = {"micro_structured_texf": np.load(GOLDEN_EXT)["textures"][0],
              "sortmiddle_structured_deferred_trilinear": np.load(
                  GOLDEN_MIP)["textures_deferred_trilinear"][0]}
    worlds = [(results, PAR_RANKS, "gloo"), ([nccl], 1, "nccl")]
    for res, world, backend in worlds:
        for case in (plan if backend == "gloo" else
                     [dict(name="sortmiddle_san_miguel_nccl",
                           kind="sharded", ns=(1,),
                           options=dict(path="sortmiddle"))]):
            if case["kind"] != "sharded":
                continue
            for n in case["ns"]:
                tag = f"{case['name']}_n{n}"
                rgba, keys = res[0]["frames"][tag]
                ref_rgba, ref_keys = refs[case["name"]]
                require(np.array_equal(rgba, ref_rgba)
                        and np.array_equal(keys, ref_keys),
                        f"{tag}: the frame differs from the single-device "
                        f"frame ({int((rgba != ref_rgba).any(-1).sum())} "
                        "px)")
                digest = par_digest(rgba, keys)
                for r in range(1, n):
                    require(res[r]["frames"][tag] == digest,
                            f"{tag}: rank {r}'s frame differs from rank 0's")
                    par_check_counts(f"{tag} rank {r}", res[r]["counts"][tag],
                                     case["options"]["path"])
                par_check_counts(f"{tag} rank 0", res[0]["counts"][tag],
                                 case["options"]["path"])
                stats = res[0]["stats"][tag]
                line = (f"[parallel] {tag} ({backend}): bitwise equal to the "
                        f"single-device frame on {n} rank(s), "
                        f"{int((keys != 0xFFFFFFFF).sum())} covered px; "
                        f"launches rank 0 {res[0]['counts'][tag]}; caps "
                        f"{stats}")
                if case["options"]["path"] == "sortmiddle":
                    # Both sort-middle rows gather the 32-column table
                    # (base; vis, whose table is the base one).
                    T = meshes[case.get("mesh", "san_miguel")].num_triangles
                    rows = n * -(-T // n)
                    stride = raster.table_stride(raster.TRI_TABLE_WIDTH)
                    line += (f"; bucket_cap {stats['bucket_cap']}, gathered "
                             f"table ({rows}, {stride}) f32 = "
                             f"{rows * stride * 4 / 2**20:.1f} MiB")
                print(line)
                if case["name"] in golden:
                    check_golden(f"parallel {tag}", [rgba],
                                 golden[case["name"]][None])

    # Frame-parallel and 2-D frames against one renderer's frames.
    from compute_renderer_torch import Renderer

    singles = {}
    for name, mesh, seq, options in (
            ("frames_suzanne_wave", suz.mesh, wave_seq,
             dict(tile_autotune=False)),
            ("frames_san_miguel", sm.mesh, sm_seq, {}),
            ("frames2d_suzanne_wave", suz.mesh, wave_seq[:4],
             dict(path="micro"))):
        r = Renderer(mesh, W, H, device=device, **options)
        singles[name] = r.render_batch_device(seq).cpu().numpy()
    for case in plan:
        if case["kind"] == "sharded":
            continue
        for n in case["ns"]:
            tag = f"{case['name']}_n{n}"
            (frames,) = results[0]["frames"][tag]
            require(frames.shape == singles[case["name"]].shape
                    and np.array_equal(frames, singles[case["name"]]),
                    f"{tag}: the frames differ from one renderer's")
            digest = par_digest(frames)
            members = PAR_RANKS if case["kind"] == "frames2d" else n
            for r in range(members):
                if r:
                    require(results[r]["frames"][tag] == digest,
                            f"{tag}: rank {r}'s frames differ from rank 0's")
                par_check_counts(f"{tag} rank {r}",
                                 results[r]["counts"][tag],
                                 "micro" if case["kind"] == "frames2d"
                                 or case["mesh"] == "san_miguel" else "tile")
                if case["kind"] == "frames":
                    replays, graphs = results[r]["replays"][tag]
                    require(replays >= len(case["frames"]) // n
                            and graphs >= 1,
                            f"{tag} rank {r}: {replays} graph replays, "
                            f"{graphs} graphs")
            print(f"[parallel] {tag}: {frames.shape[0]} frames bitwise "
                  f"equal to one renderer's on {members} rank(s); launches "
                  f"rank 0 {results[0]['counts'][tag]}"
                  + (f"; replays (and graphs) by rank "
                     f"{[results[r]['replays'][tag] for r in range(n)]}"
                     if case["kind"] == "frames" else ""))

    # Times: host ms a frame, fenced, at each group size.
    print(f"[parallel] ms/frame (host clock, fenced; {PAR_TIMED_CALLS} "
          f"calls a stripe decomposition after one, the frame-parallel "
          f"batch of {PAR_FRAMES} after one; all ranks share one card, so "
          f"these are not scaling numbers) | {card}")
    for res in (results[0], nccl):
        for tag, ms in res["ms"].items():
            print(f"[parallel-ms] {tag}: {ms:.3f} ms/frame | {card}")
    st = stage_timings_sortmiddle(sm.mesh, u_sm, W, H, PAR_RANKS,
                                  device=device)
    print(f"[parallel] stage_timings_sortmiddle San Miguel n={PAR_RANKS}: "
          f"{json.dumps(st)} | {card}")
    print(f"[parallel] phase 17: {time.perf_counter() - t_phase:.1f} s")


# Phase 18: the viewers (app/window.py, app/webview.py) and the NumPy
# oracle (golden/) on the card.
VIEW_TICKS = 200
VIEW_STEADY = 10  # ticks left out of the steady rates (tuning, capture)
# The window run's mouse drag: right over these ticks, back left over the
# next as many (2 px a tick), so the model stays ahead of the camera.
VIEW_DRAG = (60, 90)
VIEW_DRAG_PX = 2
VIEW_WEB_TICKS = 100
VIEW_RESIZE = (640, 480)
VIEW_TIMEOUT_S = 120.0  # a viewer subprocess's limit
# The oracle's cases: tests/test_fuzz.py's frame and seeds (no effect),
# its pinhole frame, and tests/test_golden.py's frame.
ORACLE_SOUP = (128, 48)
ORACLE_SEEDS = (3, 57, 7, 23, 101, 11, 42, 5)
ORACLE_PINHOLE = (256, 192)
ORACLE_CASE = (64, 64)
ORACLE_GATE = 0.005  # share of pixels more than 1 LSB off (test_fuzz.py)


class FakeWidget:
    """The Tk root and canvas of the window run (the card's machine has no
    display), shaped like tests/test_window.py's fake: it records the
    bindings, the re-armed ticks and the HUD text."""

    def __init__(self, *a, **k):
        self.bindings = {}
        self.after_calls = 0
        self.text_items = {}
        self.destroyed = False

    def title(self, *_):
        pass

    def pack(self, *_, **__):
        pass

    def config(self, **_):
        pass

    def bind(self, event, fn):
        self.bindings[event] = fn

    def create_image(self, *a, **k):
        pass

    def create_text(self, *a, **k):
        item = len(self.text_items) + 1
        self.text_items[item] = k
        return item

    def itemconfigure(self, item, **k):
        self.text_items[item].update(k)

    def tag_raise(self, item):
        pass

    def after(self, ms, fn):
        self.after_calls += 1

    def destroy(self):
        self.destroyed = True

    def mainloop(self):
        pass


class FakePhoto:
    """Tk's PhotoImage: keeps the PPM payload of the last blit only."""

    last = None

    def __init__(self, data=None, format=None):
        require(format == "PPM", f"blit format {format}")
        FakePhoto.last = data


class FixedClock:
    """``time`` for a viewer module: perf_counter advances by DT a call,
    so the camera moves the same at every tick rate."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        now = self.t
        self.t += DT
        return now


def fake_tk():
    import types

    return types.SimpleNamespace(Tk=FakeWidget, Canvas=FakeWidget,
                                 PhotoImage=FakePhoto)


def viewer_scenes():
    """(name, SceneConfig, path) of the viewer runs: Suzanne (the tile
    path's front + raster) and the San Miguel stand-in (the micro path's
    front + expansion + micro raster), first-person cameras; Suzanne's far
    enough back that holding w walks up to it."""
    from compute_renderer_torch import CameraConfig, SceneConfig

    return (("suzanne", SceneConfig(
                model_path="suzanne.obj",
                camera_config=CameraConfig.first_person((0.0, 0.0, 20.0))),
             "tile"),
            ("san_miguel", SceneConfig(
                model_path=SAN_MIGUEL,
                camera_config=CameraConfig.first_person(SAN_MIGUEL_EYE)),
             "micro"))


class ViewerProbe:
    """Wraps a viewer's tick parts to count and time them on the host
    clock: the dispatch (``render_batch_device``), the one blocking wait
    (``_fetch``), the present (``_blit`` or ``_present``) and the checked
    renders and overflow flushes; records each tick's uniforms and a copy
    of each presented frame."""

    def __init__(self, app, present):
        import numpy as np

        self.uniforms, self.shown = [], []
        self.ms = {"dispatch": [], "wait": [], "present": []}
        self.checked = 0
        self.flushes = []
        r = app.renderer
        dispatch, fetch, flush = (r.render_batch_device, app._fetch,
                                  r.flush_overflow)
        show, update, render = getattr(app, present), app.scene.update, r.render

        def timed(key, fn):
            def wrapper(*a, **k):
                t0 = time.perf_counter()
                out = fn(*a, **k)
                self.ms[key].append((time.perf_counter() - t0) * 1e3)
                return out
            return wrapper

        def shown(rgba):
            self.shown.append(np.array(rgba))
            return show(rgba)

        def checked(u):
            self.checked += 1
            return render(u)

        def flushed():
            # (the tick, whether an unchecked frame since the last flush
            # overflowed); the tick's uniforms are already recorded.
            self.flushes.append((len(self.uniforms) - 1, flush()))
            return self.flushes[-1][1]

        def updated(dt):
            self.uniforms.append(update(dt))
            return self.uniforms[-1]

        r.render_batch_device = timed("dispatch", dispatch)
        r.render = checked
        r.flush_overflow = flushed
        app._fetch = timed("wait", fetch)
        setattr(app, present, timed("present", shown))
        app.scene.update = updated

    def means(self, start=VIEW_STEADY):
        """Mean ms of each part over the ticks from ``start`` on."""
        return {k: sum(v[start:]) / max(len(v[start:]), 1)
                for k, v in self.ms.items()}


def check_lagged(app, probe, device, path, first=0):
    """Holds each presented frame from tick ``first`` on to a checked
    render of the uniforms it shows, by a second renderer with the
    viewer's tile shape: the previous tick's, or its own on a warm-up
    tick (``first``, or after an overflow's checked render) and on that
    checked render's tick. Returns (frames checked, {tick: pixels that
    differ} of the frames not bitwise equal, {tick: pixels} of those
    among them whose unchecked render a later flush reported as
    overflowing: the viewer's dropped triangles, shown until that flush,
    window.py's design)."""
    import numpy as np

    from compute_renderer_torch import Renderer

    r = app.renderer
    opts = dict(app.scene.renderer_options(), path=path)
    opts.update({k: r.options[k] for k in ("tile_h", "tile_w")
                 if k in r.options})
    ref = Renderer(app.scene.mesh, r.width, r.height, device=device, **opts)
    n = len(probe.shown)
    # The flushes, and a last one closing the run (unwrapped: not a tick).
    flushes = probe.flushes + [(n, bool(r.take_overflow().cpu().any()))]
    hits = {k for k, hit in flushes if hit}
    bad, dropped = {}, {}
    for k in range(first, n):
        src = k if k == first or k in hits or k - 1 in hits else k - 1
        want = ref.render(probe.uniforms[src])
        if np.array_equal(probe.shown[k], want):
            continue
        px = int((probe.shown[k] != want).any(axis=-1).sum())
        covering = min(f for f, _ in flushes if f > src)
        if k not in hits and covering in hits:
            dropped[k] = px
        else:
            bad[k] = px
    return n - first, bad, dropped


def view_window(device, card, name, config, path, width=W, height=H,
                ticks=VIEW_TICKS):
    """The Tk viewer on ``config`` through the fake Tk at the fixed
    clock: w held throughout, a mouse drag over VIEW_DRAG; one blocking
    wait a tick, no checked render, the presented frames lagging one tick
    bitwise. Returns the launch counts of the ticks."""
    from compute_renderer_torch.app import window

    tag = f"window {name}"
    window.time = FixedClock()
    try:
        app = window.InteractiveApp([config], width, height,
                                    tk_module=fake_tk(), device=device)
        probe = ViewerProbe(app, "_blit")
        app._on_key_press(types_event(keysym="w"))
        x, y = width // 2, height // 2
        d0, d1 = VIEW_DRAG
        reset_counts()
        t_ticks = []
        for k in range(ticks):
            if k == d0:
                app._on_mouse_down(types_event(x=x, y=y))
            elif d0 < k <= d1 + (d1 - d0):
                x += VIEW_DRAG_PX if k <= d1 else -VIEW_DRAG_PX
                app._on_mouse_move(types_event(x=x, y=y))
            elif k == d1 + (d1 - d0) + 1:
                app._on_mouse_up(types_event())
            t0 = time.perf_counter()
            app._tick()
            t_ticks.append(time.perf_counter() - t0)
        if device.type == "cuda":
            torch_sync()
        counts = {k: v for k, v in read_counts().items() if v}
    finally:
        window.time = time
    n_fetch = len(probe.ms["wait"])
    cam = app.scene.get_active_camera()
    n, bad, dropped = check_lagged(app, probe, device, path)
    steady = t_ticks[VIEW_STEADY:]
    hits = [k for k, hit in probe.flushes if hit]
    m = probe.means()
    print(f"[viewer] {tag} {width}x{height} ({path} path, "
          f"T={app.scene.mesh.num_triangles}): {ticks} ticks, "
          f"{len(steady) / sum(steady):.1f} ticks/s steady "
          f"(ticks {VIEW_STEADY}-{ticks - 1}), first tick "
          f"{t_ticks[0] * 1e3:.1f} ms; a tick: dispatch "
          f"{m['dispatch']:.3f} ms, wait {m['wait']:.3f} ms, blit "
          f"{m['present']:.3f} ms; {n_fetch} blocking waits, 0 checked "
          f"renders, {len(probe.flushes)} flushes (overflow at ticks "
          f"{hits}); {n - len(bad) - len(dropped)} of {n} presented frames "
          f"bitwise the render of the previous tick's uniforms; camera yaw "
          f"{float(cam.yaw):.3f} eye {[round(float(v), 3) for v in cam.eye]}"
          f"; launches {counts}; card: {card}")
    require(n_fetch == ticks and probe.checked == 0,
            f"{tag}: {n_fetch} blocking waits and {probe.checked} checked "
            f"renders in {ticks} ticks (want {ticks} and 0)")
    require(app.root.after_calls == ticks and app._hud is not None,
            f"{tag}: the loop re-armed {app.root.after_calls} times")
    require(not bad and not dropped and not hits,
            f"{tag}: presented frames that are not the render of the "
            f"previous tick's uniforms, pixels differing by tick: {bad}; "
            f"overflowed {dropped} (flushes {probe.flushes})")
    return counts


def types_event(**k):
    import types

    return types.SimpleNamespace(**k)


def torch_sync():
    import torch

    torch.cuda.synchronize()


def http(port, path, payload=None):
    """(body, headers) of a GET (or a POST of ``payload``) to the viewer
    on 127.0.0.1:``port``."""
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f"http://127.0.0.1:{port}{path}", data=data,
                                 method="GET" if data is None else "POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return r.read(), dict(r.headers)


def view_web(device, card, width=W, height=H, ticks=VIEW_WEB_TICKS,
             resize=VIEW_RESIZE):
    """The HTTP viewer on Suzanne on an ephemeral port: the page, a key, a
    drag and a resize posted with urllib; every served frame (decoded
    with zlib) bitwise the render of the previous tick's uniforms; /stats;
    POST /quit. Returns the launch counts of the ticks."""
    from compute_renderer_torch.app import webview

    tag = "web suzanne"
    (_, config, path), _ = viewer_scenes()
    webview.time = FixedClock()
    app = None
    try:
        app = webview.WebViewerApp([config], width, height, port=0,
                                   device=device)
        probe = ViewerProbe(app, "_present")
        page, _ = http(app.port, "/")
        require(b"/frame" in page and b"/input" in page, f"{tag}: page")
        reset_counts()
        t0 = time.perf_counter()
        http(app.port, "/input", {"kind": "keydown", "key": "w"})
        app.tick()
        http(app.port, "/input", {"kind": "mousedown", "x": 500, "y": 380})
        http(app.port, "/input", {"kind": "mousemove", "x": 530, "y": 390})
        http(app.port, "/input", {"kind": "mouseup"})
        t_ticks = []
        for k in range(1, ticks):
            t1 = time.perf_counter()
            app.tick()
            t_ticks.append(time.perf_counter() - t1)
        if device.type == "cuda":
            torch_sync()
        counts = {k: v for k, v in read_counts().items() if v}
        png, headers = http(app.port, f"/frame?since={ticks - 1}")
        require(int(headers["X-Frame-No"]) == ticks and "fps" in
                headers["X-HUD"], f"{tag}: frame {headers}")
        served, png_bytes = decode_png(png), len(png)
        require(served.shape == (height, width, 4) and bool(
            (served == probe.shown[-1]).all()),
            f"{tag}: the served PNG is not the presented frame")
        n, bad, dropped = check_lagged(app, probe, device, path)
        require(not bad, f"{tag}: served frames that are not the render of "
                f"the uniforms they show, pixels by tick: {bad}")
        hits = [k for k, hit in probe.flushes if hit]
        m = probe.means()
        steady = t_ticks[VIEW_STEADY:]
        # The resize: the next frames render at the new size.
        rw, rh = resize
        first = len(probe.shown)
        http(app.port, "/input", {"kind": "resize", "w": rw, "h": rh})
        for _ in range(3):
            app.tick()
        png, _ = http(app.port, "/frame?since=0")
        resized = decode_png(png)
        require(resized.shape == (rh, rw, 4),
                f"{tag}: after the resize {resized.shape}")
        n_resized, bad, dropped_resized = check_lagged(
            app, probe, device, path, first=first)
        require(not bad, f"{tag}: after the resize, frames that are not "
                f"the render of the uniforms they show: {bad}")
        stats = json.loads(http(app.port, "/stats")[0])
        require((stats["width"], stats["height"]) == (rw, rh)
                and stats["frames"] == len(probe.shown),
                f"{tag}: stats {stats}")
        n_waits = len(probe.ms["wait"])
        require(n_waits + probe.checked == len(probe.shown)
                and probe.checked == len(hits),
                f"{tag}: {n_waits} waits, {probe.checked} checked renders "
                f"for {len(probe.shown)} ticks and overflows at {hits}")
        http(app.port, "/quit", {})
        app.tick()
        require(not app.running, f"{tag}: /quit did not stop the loop")
    finally:
        webview.time = time
        if app is not None:
            app.shutdown()
    print(f"[viewer] {tag} {width}x{height}: {ticks} ticks, "
          f"{len(steady) / sum(steady):.1f} ticks/s steady, a tick: "
          f"dispatch {m['dispatch']:.3f} ms, wait {m['wait']:.3f} ms, PNG "
          f"encode (_present) {m['present']:.3f} ms ({png_bytes} B PNG); "
          f"{n_waits} blocking waits, {probe.checked} checked "
          f"renders (overflow at the flushes of ticks {hits}); "
          f"{n - len(dropped)} of {n} served frames bitwise the render of "
          f"the uniforms they show (the previous tick's but on warm-up and "
          f"at a checked render), the others dropped triangles before an "
          f"overflow's flush, px by tick {dropped}; {n_resized} more after "
          f"the resize to {rw}x{rh} (dropped {dropped_resized}); /stats "
          f"{stats}; launches {counts}; card: {card}")
    return counts


def view_cli(device, width=W, height=H):
    """The viewers through the CLI in subprocesses: ``--interactive
    --frames 2`` falls back to headless (no display) and writes both
    PNGs; ``--web 0`` prints its URL, serves a frame and exits 0 on POST
    /quit."""
    import queue
    import threading

    dev = [] if device.type == "cuda" else ["--device", "cpu"]
    size = ["--width", str(width), "--height", str(height)]
    out_dir = os.path.join(ROOT, "build", "viewer")
    os.makedirs(out_dir, exist_ok=True)
    for f in os.listdir(out_dir):
        os.remove(os.path.join(out_dir, f))
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "compute_renderer_torch", *dev, *size,
         "--interactive", "--frames", "2", "--output",
         os.path.join(out_dir, "i.png")], cwd=ROOT, capture_output=True,
        text=True, timeout=VIEW_TIMEOUT_S)
    require(proc.returncode == 0 and "Falling back to headless."
            in proc.stderr, f"cli --interactive: exit {proc.returncode}: "
            f"{proc.stderr[-2000:]}")
    for name in ("i_0000.png", "i_0001.png"):
        img = read_png(os.path.join(out_dir, name))
        require(img.shape == (height, width, 4), f"cli {name}: {img.shape}")
    t_interactive = time.perf_counter() - t0

    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "compute_renderer_torch", *dev, *size,
         "--web", "0"], cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        lines = queue.Queue()
        threading.Thread(target=lambda: [lines.put(x) for x in proc.stdout],
                         daemon=True).start()
        line = lines.get(timeout=VIEW_TIMEOUT_S)
        require(line.startswith("web viewer: http://127.0.0.1:"),
                f"cli --web: first line {line!r}")
        port = int(line.rsplit(":", 1)[1].strip().strip("/"))
        png, headers = http(port, "/frame?since=0")
        img = decode_png(png)
        require(img.shape == (height, width, 4)
                and int(headers["X-Frame-No"]) >= 1,
                f"cli --web: frame {img.shape} {headers}")
        http(port, "/quit", {})
        rc = proc.wait(timeout=VIEW_TIMEOUT_S)
        require(rc == 0, f"cli --web: exit {rc}: {proc.stderr.read()[-2000:]}")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    print(f"[viewer] cli: --interactive --frames 2 fell back to headless and "
          f"wrote both PNGs ({t_interactive:.1f} s); --web 0 served frame "
          f"{headers['X-Frame-No']} on port {port} and exited 0 on /quit "
          f"({time.perf_counter() - t0:.1f} s); each a fresh process")


def oracle_soup(seed, width, height):
    """tests/test_fuzz.py:106-127's draws for ``seed`` (its random_soup,
    random_camera and random_lights, copied): (mesh, camera, lights)."""
    import numpy as np

    from compute_renderer_torch.core.camera import Camera
    from compute_renderer_torch.core.types import Mesh

    f32 = np.float32
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 30))
    pos = rng.uniform(-2.0, 2.0, (n * 3, 3)).astype(f32)
    nrm = rng.normal(size=(n * 3, 3)).astype(f32)
    uv = rng.uniform(0, 1, (n * 3, 2)).astype(f32)
    mesh = Mesh(pos, nrm, uv, np.arange(n * 3, dtype=np.uint32))
    if rng.random() < 0.5:
        cam = Camera.first_person(rng.uniform(-1, 1, 3) + [0, 0, 4],
                                  width / height)
    else:
        cam = Camera.orbit(float(rng.uniform(2, 6)),
                           float(rng.uniform(0, 360)),
                           float(rng.uniform(-60, 60)),
                           rng.uniform(-1, 1, 3), width / height)
    lights = (rng.uniform(-6, 6, (2, 3)).astype(f32),
              rng.uniform(0, 1, (2, 3)).astype(f32),
              rng.uniform(0, 2, (2,)).astype(f32))
    return mesh, cam, lights


def oracle_case(name):
    """(mesh, lights) of a tests/test_golden.py case."""
    import numpy as np

    from compute_renderer_torch.core.types import Mesh
    from compute_renderer_torch.io import procedural

    f32 = np.float32
    tri = procedural.single_triangle
    one = (np.array([[0, 0, 5.0]], f32), np.ones((1, 3), f32),
           np.ones((1,), f32))
    if name == "backface":
        m = tri(z=0.0)
        m.indices = m.indices[::-1].copy()
        return m, one
    if name == "near_plane":
        m = tri(z=0.0)
        m.positions[2, 2] = 10.0
        return m, one
    if name == "two_lights":
        return tri(z=0.0), (np.tile(one[0], (2, 1)), np.ones((2, 3), f32),
                            np.ones((2,), f32))
    if name == "one_light":
        return tri(z=0.0), one
    if name == "front_only":
        return tri(z=1.0), one
    a, b = ((tri(z=0.0), tri(z=1.0)) if name == "depth_order"
            else (tri(z=0.0), tri(z=0.0)))
    both = Mesh.concatenate([a, b])
    both.normals[:3] = [1, 0, 0] if name == "depth_order" else [0, 0, 1]
    both.normals[3:] = [0, 0, 1] if name == "depth_order" else 0.5
    return both, one


def oracle_frames(device, mesh, cam, lights, width, height):
    """(oracle frame, {path: card frame}) of one scene, no effect."""
    from compute_renderer_torch import Renderer
    from compute_renderer_torch.core.effects import EffectUniform
    from compute_renderer_torch.engine.scene import FrameUniforms
    from compute_renderer_torch.golden import render_golden

    u = cam.uniform()
    effect = EffectUniform().as_array()
    gold = render_golden(mesh.positions, mesh.normals, mesh.uvs,
                         mesh.indices, u.view_proj, u.view_position,
                         *lights, effect, width, height)
    uni = FrameUniforms(view_position=u.view_position, view_proj=u.view_proj,
                        light_world_pos=lights[0], light_color=lights[1],
                        light_intensity=lights[2], effect=effect)
    return gold, {path: Renderer(mesh, width, height, device=device,
                                 path=path).render(uni)
                  for path in ("tile", "micro")}


def off_by_more_than(a, b, lsb=1):
    import numpy as np

    return int((np.abs(a.astype(np.int32) - b.astype(np.int32)) > lsb)
               .any(axis=-1).sum())


def oracle_on_card(device, card):
    """The port's NumPy oracle against ``Renderer`` on ``device``, tile
    and micro paths, at the JAX package's gates: the seeded soups
    (tests/test_fuzz.py, no effect) at most ORACLE_GATE of the pixels
    more than 1 LSB off; the pinhole frame (icosphere(3), orbit) no
    background pixel inside the silhouette; tests/test_golden.py's depth
    order, depth tie, backface, near plane and two lights, each case's
    own assertion on the card's frames and the soups' gate against the
    oracle. Prints the pixel counts of each case."""
    import numpy as np

    from compute_renderer_torch.core.camera import Camera
    from compute_renderer_torch.io import procedural

    w, h = ORACLE_SOUP
    gate = int(ORACLE_GATE * w * h)
    for seed in ORACLE_SEEDS:
        mesh, cam, lights = oracle_soup(seed, w, h)
        gold, card_frames = oracle_frames(device, mesh, cam, lights, w, h)
        offs = {p: off_by_more_than(f, gold) for p, f in card_frames.items()}
        covered = int((gold != [0, 0, 255, 255]).any(axis=-1).sum())
        require(max(offs.values()) <= gate, f"oracle soup {seed}: {offs} px "
                f"more than 1 LSB off (gate {gate})")
        print(f"[oracle] soup seed {seed} ({mesh.num_triangles} tris, "
              f"{covered} covered px of {w * h}): more than 1 LSB off the "
              f"oracle: tile {offs['tile']}, micro {offs['micro']} (gate "
              f"{gate})")

    w, h = ORACLE_PINHOLE
    mesh = procedural.icosphere(3)
    cam = Camera.orbit(4.0, 0.0, 0.0, [0, 0, 0], aspect=w / h)
    rng = np.random.default_rng(0)  # test_fuzz.py:140's lights
    lights = (rng.uniform(-6, 6, (2, 3)).astype(np.float32),
              rng.uniform(0, 1, (2, 3)).astype(np.float32),
              rng.uniform(0, 2, (2,)).astype(np.float32))
    gold, card_frames = oracle_frames(device, mesh, cam, lights, w, h)
    ys, xs = np.mgrid[0:h, 0:w]
    inside = ((xs - w / 2) ** 2 + (ys - h / 2) ** 2) < 20 ** 2
    holes = {p: int(((f[..., :3] == [0, 0, 255]).all(-1) & inside).sum())
             for p, f in dict(card_frames, oracle=gold).items()}
    offs = {p: off_by_more_than(f, gold) for p, f in card_frames.items()}
    require(not any(holes.values()) and max(offs.values()) <= int(
        ORACLE_GATE * w * h), f"oracle pinhole: holes {holes}, off {offs}")
    print(f"[oracle] pinhole icosphere(3) {w}x{h}: background px inside the "
          f"silhouette {holes}; more than 1 LSB off the oracle {offs}")

    w, h = ORACLE_CASE
    cam = Camera.first_person([0, 0, 3.0], aspect=w / h)
    blue = np.array([0, 0, 255, 255], np.uint8)
    cases = {}
    for name in ("depth_order", "depth_tie", "backface", "near_plane",
                 "two_lights", "one_light", "front_only"):
        mesh, lights = oracle_case(name)
        cases[name] = oracle_frames(device, mesh, cam, lights, w, h)
    for name in ("depth_order", "depth_tie", "backface", "near_plane",
                 "two_lights"):
        gold, card_frames = cases[name]
        for path, img in card_frames.items():
            tag = f"oracle {name} {path}"
            off = off_by_more_than(img, gold)
            require(off <= int(ORACLE_GATE * w * h), f"{tag}: {off} px off")
            if name in ("backface", "near_plane"):
                ok = bool((img == blue).all())
            elif name in ("depth_order", "depth_tie"):
                only = cases["front_only" if name == "depth_order"
                             else "one_light"][1][path]
                cover = ~(only == blue).all(axis=-1)
                ok = cover.any() and np.array_equal(img[cover], only[cover])
            else:
                one = cases["one_light"][1][path]
                cover = ~(one == blue).all(axis=-1)
                ok = (img[cover].astype(int).sum()
                      >= one[cover].astype(int).sum())
            require(ok, f"{tag}: the case's own assertion fails on the card")
        covered = {p: int((~(f == blue).all(axis=-1)).sum())
                   for p, f in card_frames.items()}
        print(f"[oracle] {name} {w}x{h}: covered px {covered}, more than 1 "
              f"LSB off the oracle: "
              + ", ".join(f"{p} {off_by_more_than(f, gold)}"
                          for p, f in card_frames.items())
              + f"; card: {card}")


def phase_viewers(device, card):
    """Phase 18: the viewers and the oracle on the card. (a) The Tk
    viewer through a fake Tk at the fixed clock on Suzanne (tile path)
    and the San Miguel stand-in (micro path), VIEW_TICKS ticks each with
    w held and a mouse drag: one blocking wait a tick, no checked render,
    every presented frame bitwise the render of the previous tick's
    uniforms, the kernels of both paths launched by the ticks; ticks/s and
    the host split (dispatch, wait, blit). (b) The HTTP viewer on Suzanne on
    an ephemeral port driven with urllib: a key, a drag, a resize, the
    served PNGs bitwise, /stats, /quit; ticks/s and the PNG encode. (c)
    The CLI's --interactive (headless fallback) and --web 0 in
    subprocesses. (d) The NumPy oracle against the card's frames."""
    t_phase = time.perf_counter()
    launched = {}
    for name, config, path in viewer_scenes():
        counts = view_window(device, card, name, config, path)
        kernels = (("front_end", "raster_shade_tiles") if path == "tile"
                   else ("front_end", "expand_cells", "raster_shade_micro"))
        require(all(counts.get(k, 0) > 0 for k in kernels),
                f"window {name}: the {path} path's kernels did not launch "
                f"({counts})")
        for k, v in counts.items():
            launched[k] = launched.get(k, 0) + v
    # The viewers' scenes are untextured: every kernel but the texture
    # stages', which never launch there.
    require(all((launched.get(k, 0) > 0) != (k in TEXTURE_KERNELS)
                for k in counters()),
            f"viewers: not every kernel launched ({launched})")
    counts = view_web(device, card)
    require(counts.get("front_end", 0) > 0
            and counts.get("raster_shade_tiles", 0) > 0,
            f"web suzanne: the tile path's kernels did not launch ({counts})")
    view_cli(device)
    oracle_on_card(device, card)
    print(f"[viewer] phase 18: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "compute_renderer_torch")):
        print("chip_smoke: compute_renderer_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import faulthandler

    import torch

    faulthandler.enable()  # a crash in native code prints the Python stack
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from compute_renderer_torch.bench.profiling import card_line

    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from compute_renderer_torch import _build

    t0 = time.perf_counter()
    _build.build_all(["front", "raster", "expand", "micro", "bins",
                      "texture", "sort"])
    print(f"[build] {time.perf_counter() - t0:.2f} s (in parallel)")
    for name, (secs, log) in _build.BUILD_LOG.items():
        print(f"[build] {name}.cu {secs:.2f} s: " + "; ".join(
            f"{k} {v}" for k, v in ptxas_report(log).items()))

    reports = {name: {} for name in KERNELS}
    t_run = time.perf_counter()

    def run(phase, *args):
        t0 = time.perf_counter()
        out = phase(*args)
        now = time.perf_counter()
        print(f"[phase] {phase.__name__}: {now - t0:.1f} s (run "
              f"{now - t_run:.1f} s)", flush=True)
        return out

    run(phase_kernels, device, reports)
    run(phase_micro_kernels, device, reports)
    run(phase_main_path, device, card, reports)
    run(phase_micro_main_path, device, card, reports)
    run(phase_san_miguel, device, reports)
    scenes = run(load_ext_scenes)
    run(check_bins_structured, device, reports, scenes)
    run(phase_sort_kernels, device, reports, scenes)
    run(phase_mode_kernels, device, reports, scenes, MODES)
    run(phase_ext_main_paths, device, card, reports, scenes)
    run(phase_mode_kernels, device, reports, scenes, NEW_MODES)
    run(phase_mip_main_paths, device, card, reports, scenes)
    run(phase_stress, device, reports)
    run(phase_graph_summary, card)
    run(phase_comparators, device, card, scenes)
    run(phase_cli_suite, device, card)
    run(phase_parallel, device, card, scenes)
    run(phase_viewers, device, card)

    kernels = [{
        "name": name, "route": "cuda", "source": meta["source"],
        "replaces": tpu_kernel_location(*meta["replaces"]),
        "launches": reports[name]["launches"],
        "max_abs_err": reports[name]["max_abs_err"],
        "ms": (reports[name]["ms"] if reports[name]["ms"] is not None
               else reports[name]["ms_events"]),
        "plain_ms": reports[name]["plain_ms"],
        "bound_ms": reports[name]["bound_ms"],
        "bound_by": reports[name]["bound_by"],
        # Only the expansion has a PyTorch call near it
        # (torch.repeat_interleave, its tri_of_pair alone); none computes
        # the front's or the rasters' functions.
        "library_ms": reports[name].get("library_ms"),
    } for name, meta in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
