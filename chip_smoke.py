#!/usr/bin/env python3
"""Smoke run of the PyTorch port (compute_renderer_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device — requires CUDA; prints the card's name and power limit;
2. build — compiles the four hand-written kernels (csrc/*.cu) with nvcc,
   one process per source, all at once;
3. kernel vs twin, tile path — the front end and the raster on the tile
   path's inputs (Suzanne and san_miguel_small at 1024x768, and a wave
   frame): meta bitwise, coefficients bitwise with NaN positions equal
   (<= 1 ULP on the wave frame, whose sinf inputs differ), the raster's
   keys bitwise and RGBA within 1 LSB, dense and flat layouts;
4. kernel vs twin, micro path — the front end at 8x8 cells (meta and
   coefficients bitwise), the pair expansion (bitwise on the valid range,
   the sentinel tail, total equal, an overflowing capacity included) and
   the micro raster (keys bitwise, RGBA within 1 LSB) on the San Miguel
   stand-in (998,784 triangles), san_miguel_small forced onto the micro
   path, a mirage frame and a voxelize frame; each kernel's time beside
   its twin's at San Miguel's shapes;
5. main path, tile — bench.py's scene through Scene.from_config ->
   Renderer -> three render() frames: the front and raster launch counts
   advance, no overflow, and every frame matches
   tests/golden_data/torch_slice_suzanne_1024x768.npz (rendered by the JAX
   package) with at most max(2, H*W/500) pixels differing by more than
   2 LSB; ms/frame by bench.py's batch-slope method (64 and 256 frames,
   best of 4) and one profiled batch;
6. main path, micro — the San Miguel benchmark configuration through
   Renderer: calibration, three frames against
   tests/golden_data/torch_micro_san_miguel_1024x768.npz, the front,
   expand and micro launch counts advance and the tile raster's stays 0,
   no overflow; the batch slope and one profiled batch split into front /
   expand / sort+segments / micro / other;
7. san_miguel_small on the tile path against the CPU twin path.

Prints the kernels' JSON record and the card line before the last line,
and as the last line {"ok": true, "device": {...}}.
"""

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
W, H = 1024, 768
DT = 1.0 / 60.0
BATCH_SMALL, BATCH_LARGE, ROUNDS = 64, 256, 4  # bench.py's batch slope
GOLDEN = os.path.join(ROOT, "tests", "golden_data",
                      "torch_slice_suzanne_1024x768.npz")
GOLDEN_MICRO = os.path.join(ROOT, "tests", "golden_data",
                            "torch_micro_san_miguel_1024x768.npz")
SAN_MIGUEL = "San_Miguel/san-miguel-low-poly.obj"
SAN_MIGUEL_EYE = (13.566635, 2.6288567, 10.243919)  # bench/suite.py
# The card's peaks for the bounds (H100 SXM data sheet):
# HBM bytes/s and float32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_OPS = 67e12
# Operations per unit of work, counted from the sources: the front end
# per triangle (3 corner transforms, setup, 9 barycentric and 21
# interpolant coefficients); a raster sample per (pair, pixel) (two
# offsets, four (A + B dx) + C dy, four compares); the expansion per pair
# slot (a binary search of ~20 steps and the rect walk, integer ops).
FRONT_OPS = 300
SAMPLE_OPS = 30
EXPAND_OPS = 60
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
}


def tpu_kernel_location(filename, function):
    """"path:line" of ``def function(`` in the JAX package's
    ``backends/<filename>`` — the TPU kernel a CUDA kernel replaces."""
    import glob

    for path in sorted(glob.glob(os.path.join(ROOT, "*", "backends",
                                              filename))):
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


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    return out[0].strip()


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


def event_ms(fn, iters):
    """Mean wall time per call on the card's clock (CUDA events around
    ``iters`` back-to-back calls, after a warm-up)."""
    import torch

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


def kernel_device_ms(fn, iters, symbol):
    """Mean device time of the kernel named ``symbol`` per call of ``fn``,
    from torch.profiler; None when the profiler records no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        averages = prof.key_averages()
    except (RuntimeError, AssertionError) as e:  # optional here
        print(f"[time] profiler unavailable: {e!r}")
        return None
    for ev in averages:
        if symbol in ev.key and ev.count:
            total = getattr(ev, "device_time_total", None)
            if total is None:
                total = ev.cuda_time_total
            return total / ev.count / 1e3 if total else None
    return None


def ulps(a, b):
    """Per-element ULP distance of two f32 tensors (same-sign lattice)."""
    import torch

    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return (ia - ib).abs()


def frame_inputs(scene, device):
    """The main path's per-frame tensors for the scene's next frame."""
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
        "lc": lc, "li": li, "T": int(tri.shape[0]),
    }


def check_front(name, x, wave, report, tile=(16, 256)):
    """Front kernel vs twin on one frame's inputs; returns (coeff, meta)."""
    import torch

    from compute_renderer_torch.backends import front

    kw = dict(width=W, height=H, tile_h=tile[0], tile_w=tile[1])
    args = (x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"])
    ck, mk = front.front_end(*args, **kw)  # the public wrapper's card route
    cp, mp = front.front_end_plain(*args, **kw)
    torch.cuda.synchronize()
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
    print(f"[check] front {name} {tile[0]}x{tile[1]}: T={x['T']} meta "
          f"bitwise, coeff worst "
          f"{worst_ulp} ULP (limit {limit}), max abs {max_abs:g}")
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), max_abs)
    return ck, mk


def check_raster(name, x, coeff, meta, caps, report):
    """Raster kernel vs twin on one frame, both layouts; returns each
    layout's inputs for the timing runs."""
    import torch

    from compute_renderer_torch.backends import binning, raster

    ntx = (W + 255) // 256
    nty = (H + 15) // 16
    setup = binning.setup_from_meta(meta)
    table = coeff.T.contiguous()
    params, lights = raster.shading_inputs(x["eff"], x["vpos"], x["lwp"],
                                           x["lc"], x["li"])
    kw = dict(height_padded=nty * 16, width_padded=ntx * 256, tile_h=16,
              tile_w=256)
    inputs = {}
    for layout, binner in (("dense", binning.bin_triangles_dense),
                           ("flat", binning.bin_triangles_sort)):
        bins = binner(setup, ntx, nty, caps["pair_cap"], caps["tile_cap"])
        flags = torch.stack([bins["pair_needed"], bins["tile_needed"]])
        require(not bool(flags.any()), f"raster {name} {layout}: overflow "
                f"{flags.tolist()} at caps {caps}")
        data = bins["bin_rows"] if layout == "dense" else bins["pair_tri"]
        # The public wrapper's card route (on-device shading inputs, u32
        # outputs) against the twin on the same inputs.
        rk, kk = raster.raster_shade_tiles(
            table, data, bins["seg_start"], bins["seg_count"], x["eff"],
            x["vpos"], x["lwp"], x["lc"], x["li"], layout=layout, **kw)
        rp, kp = raster.raster_shade_tiles_plain(
            table, data, bins["seg_start"], bins["seg_count"], params,
            lights, layout=layout, **kw)
        torch.cuda.synchronize()
        kk = kk.view(torch.int32)
        require(torch.equal(kk, kp), f"raster {name} {layout}: depth keys "
                "differ from the twin")
        bk = raster.unpack_rgba(rk).to(torch.int32)
        bp = raster.unpack_rgba(rp.view(torch.uint32)).to(torch.int32)
        diff = int((bk - bp).abs().max())
        require(diff <= 1, f"raster {name} {layout}: RGBA differs by {diff}")
        covered = int((kk != -1).sum())
        print(f"[check] raster {name} {layout}: keys bitwise, RGBA max diff "
              f"{diff} LSB, covered {covered}, pairs "
              f"{int(bins['total_pairs'])}, occupied tiles "
              f"{int((bins['seg_count'] > 0).sum())}")
        report["max_abs_err"] = max(report.get("max_abs_err", 0.0),
                                    float(diff))
        inputs[layout] = (table, data, bins, params, lights, kw, layout)
    return inputs


def phase_kernels(device, reports):
    from compute_renderer_torch.backends import binning, cuda, front, raster
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
        coeff, meta = check_front(name, x, effect is not None,
                                  reports["front_end"])
        caps = cuda.default_caps("tile", x["T"], W, H)
        # Size the caps to this frame's exact need, as the engine's retry
        # would, so that both layouts fit.
        setup = binning.setup_from_meta(meta)
        need = binning.exact_tile_counts(setup, (W + 255) // 256,
                                         (H + 15) // 16)
        caps["tile_cap"] = max(caps["tile_cap"], int(need.max()))
        caps["pair_cap"] = max(caps["pair_cap"], int(need.sum()))
        for layout, args in check_raster(
                name, x, coeff, meta, caps,
                reports["raster_shade_tiles"]).items():
            timing[f"{name}/{layout}"] = args

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
        table, data, bins, params, lights, rkw, layout = timing[key]
        common = (table, data, bins["seg_start"], bins["seg_count"], params,
                  lights)
        return (lambda: raster._raster_cuda(*common, layout=layout, **rkw),
                lambda: raster.raster_shade_tiles_plain(*common,
                                                        layout=layout, **rkw))

    symbol = KERNELS["raster_shade_tiles"]["symbol"]
    run_kernel, run_plain = runners("suzanne/dense")
    rep_r["ms"] = kernel_device_ms(run_kernel, 50, symbol)
    rep_r["ms_events"] = event_ms(run_kernel, 200)
    rep_r["plain_ms"] = event_ms(run_plain, 10)
    table, data, bins = timing["suzanne/dense"][:3]
    rep_r["bound_ms"], rep_r["bound_by"] = raster_bound(
        table, bins, 16 * 256, len(bins["seg_count"]), W * H)
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


def print_time(name, rep, where="suzanne"):
    print(f"[time] {name} ({where}): kernel {rep['ms']} ms (profiler "
          f"device time), {rep['ms_events']:.6f} ms (events, wrapper "
          f"included); twin {rep['plain_ms']:.6f} ms; bound "
          f"{rep['bound_ms']:.6f} ms ({rep['bound_by']})")


def raster_bound(table, bins, pixels_per_pair, segments, frame_pixels):
    """Least time of a raster launch: the binned triangles' 128-byte rows,
    the pair ids, the segments and the two u32 outputs, against
    SAMPLE_OPS per (pair, pixel)."""
    import torch

    pairs = int(bins["total_pairs"])
    if "pair_tri" in bins:
        listed = bins["pair_tri"][:pairs]
    else:  # dense rows: the first seg_count entries of each
        rows = bins["bin_rows"]
        slot = torch.arange(rows.shape[1], device=rows.device)
        listed = rows[slot[None, :] < bins["seg_count"][:, None]]
    binned = int(torch.unique(listed).numel())
    nbytes = binned * 128 + pairs * 4 + segments * 8 + frame_pixels * 8
    return bound_ms(nbytes, pairs * pixels_per_pair * SAMPLE_OPS)


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


def check_micro(name, x, table, bins, ntx, nty, report):
    """Micro raster kernel vs twin: keys bitwise, RGBA within 1 LSB."""
    import torch

    from compute_renderer_torch.backends import micro, raster

    args = (table, bins["pair_tri"], bins["seg_start"], bins["seg_count"])
    kw = dict(height_padded=nty * 8, width_padded=ntx * 128)
    rk, kk = micro.raster_shade_micro(*args, bins["tile_count"], x["eff"],
                                      x["vpos"], x["lwp"], x["lc"], x["li"],
                                      **kw)
    params, lights = raster.shading_inputs(x["eff"], x["vpos"], x["lwp"],
                                           x["lc"], x["li"])
    rp, kp = micro.raster_shade_micro_plain(*args, params, lights, **kw)
    torch.cuda.synchronize()
    kk = kk.view(torch.int32)
    require(torch.equal(kk, kp), f"micro {name}: depth keys differ from "
            "the twin")
    bk = raster.unpack_rgba(rk).to(torch.int32)
    bp = raster.unpack_rgba(rp.view(torch.uint32)).to(torch.int32)
    diff = int((bk - bp).abs().max())
    require(diff <= 1, f"micro {name}: RGBA differs by {diff}")
    counts = bins["seg_count"]
    print(f"[check] micro {name}: keys bitwise, RGBA max diff {diff} LSB, "
          f"covered {int((kk != -1).sum())}, pairs "
          f"{int(bins['total_pairs'])}, occupied tiles "
          f"{int((bins['tile_count'] > 0).sum())} of "
          f"{bins['tile_count'].numel()}, densest cell {int(counts.max())} "
          f"pairs, mean occupied cell "
          f"{float(counts[counts > 0].float().mean()):.1f}")
    report["max_abs_err"] = max(report.get("max_abs_err", 0.0), float(diff))
    return params, lights


def phase_micro_kernels(device, reports):
    from compute_renderer_torch.backends import binning, cuda, expand, front
    from compute_renderer_torch.backends import micro

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
        coeff, meta = check_front(name, x, False, reports["front_end"],
                                  tile=(8, 8))
        total = int(meta[3].sum())
        pair_cap = cuda.grow_pair_cap(0, max(total, num_cells, 1024))
        check_expand(name, meta, pair_cap, ntx, num_cells,
                     reports["expand_cells"])
        if name == "san_miguel_small":  # an overflowing capacity
            check_expand(name, meta, 1024, ntx, num_cells,
                         reports["expand_cells"])
        bins = binning.bin_cells_sort_meta(meta[3], meta[2], meta[0],
                                           meta[1], ntx, nty, pair_cap)
        require(int(bins["pair_needed"]) == 0, f"micro {name}: overflow")
        table = coeff.T.contiguous()
        params, lights = check_micro(name, x, table, bins, ntx, nty,
                                     reports["raster_shade_micro"])
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
    alive = int((meta[3] > 0).sum())
    rep["bound_ms"], rep["bound_by"] = bound_ms(
        x["T"] * 4 + alive * 12 + pair_cap * 8, pair_cap * EXPAND_OPS)
    print_time("expand_cells", rep, "san_miguel")

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
        table, bins, 64, num_cells, nty * 8 * ntx * 128)
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
    from compute_renderer_torch.backends import front, raster

    scene = bench_scene()
    renderer = Renderer(scene.mesh, W, H, device=device,
                        **scene.renderer_options())
    golden = np.load(GOLDEN)["rgba"]

    front.front_end.launches = 0
    raster.raster_shade_tiles.launches = 0
    frames = [renderer.render(scene.update(DT)) for _ in range(3)]
    launches = {"front_end": front.front_end.launches,
                "raster_shade_tiles": raster.raster_shade_tiles.launches}
    print(f"[main] launches over 3 render() frames: {launches}")
    for name, n in launches.items():
        require(n > 0, f"main path never launched the {name} kernel")
        reports[name]["launches"] = n
    require(not renderer.flush_overflow(), "overflow on the main path")
    check_golden("main", frames, golden)

    slope_ms, wall_ms = batch_slope(renderer, scene)
    print(f"[bench] ms/frame 1024x768 suzanne (cuda, batch slope "
          f"{BATCH_SMALL}->{BATCH_LARGE}, best of {ROUNDS}): {slope_ms:.6f} ;"
          f" wall ms/frame at {BATCH_LARGE}: {wall_ms:.6f} ; card: {card}")
    profile_batch(renderer, scene, slope_ms, {
        "front_end": ("front_kernel",),
        "raster_shade_tiles": ("raster_kernel",),
    })


def batch_slope(renderer, scene):
    """bench.py's batch-slope method: (ms/frame by slope, wall ms/frame at
    the large batch), best of ROUNDS, after a warm-up of both sizes."""
    def make_batch(n):
        return [scene.update(DT) for _ in range(n)]

    renderer.render_batch_device(make_batch(BATCH_SMALL))
    renderer.render_batch_device(make_batch(BATCH_LARGE))
    renderer.fence_pending()

    def timed_round(n):
        batch = make_batch(n)
        t0 = time.perf_counter()
        renderer.render_batch_device(batch, check=False)
        renderer.fence_pending()
        return time.perf_counter() - t0

    best_small = min(timed_round(BATCH_SMALL) for _ in range(ROUNDS))
    best_large = min(timed_round(BATCH_LARGE) for _ in range(ROUNDS))
    require(not renderer.flush_overflow(), "overflow during the batch runs")
    slope_ms = (best_large - best_small) / (BATCH_LARGE - BATCH_SMALL) * 1e3
    return slope_ms, best_large / BATCH_LARGE * 1e3


def profile_batch(renderer, scene, slope_ms, layers):
    """Where the time goes: one profiled 16-frame batch, device time per
    frame split by layer (``layers`` maps a layer to substrings of its
    kernels' names; the rest is "other")."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    batch = [scene.update(DT) for _ in range(16)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    try:
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            renderer.render_batch_device(batch, check=False)
            renderer.fence_pending()
        averages = prof.key_averages()
    except (RuntimeError, AssertionError) as e:  # informational only
        print(f"[profile] unavailable: {e!r}")
        averages = []
    wall = (time.perf_counter() - t0) * 1e3
    # Device kernels only: the aten rows repeat their kernels' time.
    cuda_type = torch.autograd.DeviceType.CUDA
    rows = []
    for ev in averages:
        if getattr(ev, "device_type", None) != cuda_type:
            continue
        dev = getattr(ev, "self_device_time_total", None)
        if dev is None:
            dev = getattr(ev, "self_cuda_time_total", 0)
        rows.append((dev / 1e3, ev.count, ev.key))
    rows.sort(reverse=True)
    n = len(batch)
    busy = sum(r[0] for r in rows) / n
    launches = sum(r[1] for r in rows) / n
    by_layer = {name: 0.0 for name in layers}
    by_layer["other"] = 0.0
    for ms, _, key in rows:
        layer = next((name for name, keys in layers.items()
                      if any(k in key.lower() for k in keys)), "other")
        by_layer[layer] += ms / n
    split = ", ".join(f"{k} {v:.6f}" for k, v in by_layer.items())
    print(f"[profile] {n} frames (profiler on, wall {wall:.3f} ms): device "
          f"busy {busy:.6f} ms/frame in {launches:.1f} kernels/frame "
          f"({split}); idle share against the unprofiled slope "
          f"{1 - busy / slope_ms:.4f}")
    for ms, count, key in rows[:12]:
        print(f"[profile]   {ms / n:9.6f} ms/frame  x{count // n:<3d} "
              f"{key[:80]}")
    require(not renderer.flush_overflow(), "overflow in the profiled batch")


def phase_micro_main_path(device, card, reports):
    import numpy as np

    from compute_renderer_torch import Renderer
    from compute_renderer_torch.backends import cuda, expand, front, micro
    from compute_renderer_torch.backends import raster

    scene = bench_scene(SAN_MIGUEL, eye=SAN_MIGUEL_EYE)
    require(scene.total_tris == 998_784, f"San Miguel has {scene.total_tris}"
            " triangles")
    renderer = Renderer(scene.mesh, W, H, device=device,
                        **scene.renderer_options())
    golden = np.load(GOLDEN_MICRO)["rgba"]
    counters = {"front_end": front.front_end,
                "expand_cells": expand.expand_cells,
                "raster_shade_micro": micro.raster_shade_micro,
                "raster_shade_tiles": raster.raster_shade_tiles}
    for fn in counters.values():
        fn.launches = 0
    frames = [renderer.render(scene.update(DT)) for _ in range(3)]
    launches = {name: fn.launches for name, fn in counters.items()}
    print(f"[main-micro] launches over 3 render() frames (calibration "
          f"included): {launches}")
    for name in ("front_end", "expand_cells", "raster_shade_micro"):
        require(launches[name] >= 3, f"the micro main path launched the "
                f"{name} kernel {launches[name]} times in 3 frames")
    require(launches["raster_shade_tiles"] == 0,
            "the micro main path launched the tile raster")
    # One expansion a frame: calibration left no frame to retry.
    require(launches["expand_cells"] == 3, "a frame overflowed and retried")
    for name in ("expand_cells", "raster_shade_micro"):
        reports[name]["launches"] = launches[name]
    require(not renderer.flush_overflow(), "overflow on the micro main path")
    caps = cuda.default_caps("micro", scene.total_tris, W, H)
    print(f"[main-micro] calibrated pair_cap {renderer.options['pair_cap']} "
          f"(heuristic {caps['pair_cap']})")
    check_golden("main-micro", frames, golden)

    slope_ms, wall_ms = batch_slope(renderer, scene)
    print(f"[bench] ms/frame 1024x768 san_miguel (cuda, micro path, batch "
          f"slope {BATCH_SMALL}->{BATCH_LARGE}, best of {ROUNDS}): "
          f"{slope_ms:.6f} ; wall ms/frame at {BATCH_LARGE}: {wall_ms:.6f} ;"
          f" card: {card}")
    profile_batch(renderer, scene, slope_ms, {
        "front": ("front_kernel",),
        "expand": ("expand_kernel",),
        "sort+segments": ("sort", "searchsorted"),
        "micro": ("micro_kernel",),
    })


def phase_san_miguel(device):
    import numpy as np

    from compute_renderer_torch import Renderer
    from compute_renderer_torch.backends import front, raster

    scene = bench_scene("san_miguel_small.obj")
    uniforms = scene.update(DT)
    gpu = Renderer(scene.mesh, W, H, device=device,
                   **scene.renderer_options())
    gpu.render(uniforms)  # settles the capacities (one retry at most)
    front.front_end.launches = 0
    raster.raster_shade_tiles.launches = 0
    img = gpu.render(uniforms)
    launches = (front.front_end.launches, raster.raster_shade_tiles.launches)
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
    print(f"[san_miguel_small] T={scene.total_tris} launches (front, raster)"
          f"={launches} covered {covered} px, {ndiff} px differ from the CPU "
          f"twin path (max {int(d.max())} LSB), caps {gpu.options}")


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "compute_renderer_torch")):
        print("chip_smoke: compute_renderer_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False — this script "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 3
    device = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | nvidia-smi: {card} | "
          f"torch {torch.__version__} cuda {torch.version.cuda}")

    from compute_renderer_torch import _build

    t0 = time.perf_counter()
    _build.build_all(["front", "raster", "expand", "micro"])
    print(f"[build] {time.perf_counter() - t0:.2f} s (in parallel)")
    for name, (secs, log) in _build.BUILD_LOG.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "smem" in ln]
        print(f"[build] {name}.cu {secs:.2f} s: " + " | ".join(info))

    reports = {name: {} for name in KERNELS}
    phase_kernels(device, reports)
    phase_micro_kernels(device, reports)
    phase_main_path(device, card, reports)
    phase_micro_main_path(device, card, reports)
    phase_san_miguel(device)

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
        # No single PyTorch call computes any of these functions.
        "library_ms": None,
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
