#!/usr/bin/env python3
"""Smoke run of the PyTorch port (compute_renderer_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (nonzero exit, no result line):

1. device — requires CUDA; prints the card's name and power limit;
2. build — compiles the hand-written kernels (csrc/*.cu) with nvcc;
3. kernel vs twin — each kernel against its plain torch twin on the card,
   on the main path's inputs (Suzanne and san_miguel_small at 1024x768,
   and a wave-effect frame): the front end's meta bitwise and coefficients
   bitwise with NaN positions equal (<= 1 ULP on the wave frame, whose
   sinf inputs differ), the raster's keys bitwise and RGBA within 1 LSB,
   dense and flat layouts; prints each kernel's time beside its twin's;
4. main path — bench.py's scene through Scene.from_config -> Renderer ->
   three render() frames: both kernels' launch counts must advance, no
   overflow, and every frame must match
   tests/golden_data/torch_slice_suzanne_1024x768.npz (rendered by the JAX
   package) with at most max(2, H*W/500) pixels differing and the rest
   within 2 LSB; then ms/frame by bench.py's batch-slope method (64 and
   256 frames, best of 4), one profiled batch, and one san_miguel_small
   frame checked against the twin path on the CPU.

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


def bench_scene(model="suzanne.obj", effect=None):
    from compute_renderer_torch import CameraConfig, Scene, SceneConfig
    from compute_renderer_torch.core.camera import CameraMode

    config = SceneConfig(
        model_path=model, effect=effect,
        camera_config=CameraConfig(distance=2.0, mode=CameraMode.FIRST_PERSON,
                                   position=(0.0, 0.0, 3.0)),
    )
    return Scene.from_config(config, W, H)


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


def check_front(name, x, wave, report):
    """Front kernel vs twin on one frame's inputs; returns (coeff, meta)."""
    import torch

    from compute_renderer_torch.backends import front

    kw = dict(width=W, height=H, tile_h=16, tile_w=256)
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
    print(f"[check] front {name}: T={x['T']} meta bitwise, coeff worst "
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
    # The san_miguel_small flat layout, for the record.
    run_kernel, run_plain = runners("san_miguel_small/flat")
    rep_r["ms_san_miguel_small_flat"] = kernel_device_ms(run_kernel, 20,
                                                         symbol)
    rep_r["plain_ms_san_miguel_small_flat"] = event_ms(run_plain, 3)
    for name, rep in reports.items():
        print(f"[time] {name}: kernel {rep['ms']} ms (profiler device time),"
              f" {rep['ms_events']:.6f} ms (events, wrapper included); "
              f"twin {rep['plain_ms']:.6f} ms")
    print(f"[time] raster_shade_tiles san_miguel_small flat: kernel "
          f"{rep_r['ms_san_miguel_small_flat']} ms, twin "
          f"{rep_r['plain_ms_san_miguel_small_flat']:.6f} ms")


def phase_main_path(device, card, reports):
    import numpy as np
    import torch

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
    budget = max(2, H * W // 500)
    for i, img in enumerate(frames):
        require(img.shape == (H, W, 4) and img.dtype == np.uint8,
                f"frame {i}: shape {img.shape} {img.dtype}")
        d = np.abs(img.astype(np.int32) - golden[i].astype(np.int32))
        ndiff = int((d > 0).any(axis=-1).sum())
        nbad = int((d > 2).any(axis=-1).sum())
        require(nbad <= budget, f"frame {i}: {nbad} pixels differ from the "
                f"golden frame by more than 2 LSB (budget {budget})")
        covered = int((img != np.array([0, 0, 255, 255], np.uint8))
                      .any(axis=-1).sum())
        print(f"[main] frame {i}: matches golden ({ndiff} px differ, {nbad} "
              f"by more than 2 LSB, max {int(d.max())} LSB), covered "
              f"{covered} px")

    # bench.py's batch-slope method.
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
    wall_ms = best_large / BATCH_LARGE * 1e3
    print(f"[bench] ms/frame 1024x768 suzanne (cuda, batch slope "
          f"{BATCH_SMALL}->{BATCH_LARGE}, best of {ROUNDS}): {slope_ms:.6f} ;"
          f" wall ms/frame at {BATCH_LARGE}: {wall_ms:.6f} ; card: {card}")

    # Where the time goes: one profiled 16-frame batch.
    from torch.profiler import ProfilerActivity, profile

    batch = make_batch(16)
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
    by_layer = {"front_end": 0.0, "raster_shade_tiles": 0.0, "other": 0.0}
    for ms, _, key in rows:
        layer = ("front_end" if "front_kernel" in key else
                 "raster_shade_tiles" if "raster_kernel" in key else "other")
        by_layer[layer] += ms / n
    print(f"[profile] {n} frames (profiler on, wall {wall:.3f} ms): device "
          f"busy {busy:.6f} ms/frame in {launches:.1f} kernels/frame "
          f"(front {by_layer['front_end']:.6f}, raster "
          f"{by_layer['raster_shade_tiles']:.6f}, binning and other torch "
          f"ops {by_layer['other']:.6f}); idle share against the "
          f"unprofiled slope {1 - busy / slope_ms:.4f}")
    for ms, count, key in rows[:12]:
        print(f"[profile]   {ms / n:9.6f} ms/frame  x{count // n:<3d} "
              f"{key[:80]}")
    require(not renderer.flush_overflow(), "overflow in the profiled batch")


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
    for name in ("front", "raster"):
        _build.build(name)
    print(f"[build] {time.perf_counter() - t0:.2f} s")
    for name, (secs, log) in _build.BUILD_LOG.items():
        info = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln or "smem" in ln]
        print(f"[build] {name}.cu {secs:.2f} s: " + " | ".join(info))

    reports = {name: {} for name in KERNELS}
    phase_kernels(device, reports)
    phase_main_path(device, card, reports)
    phase_san_miguel(device)

    kernels = [{
        "name": name, "route": "cuda", "source": meta["source"],
        "replaces": tpu_kernel_location(*meta["replaces"]),
        "launches": reports[name]["launches"],
        "max_abs_err": reports[name]["max_abs_err"],
        "ms": (reports[name]["ms"] if reports[name]["ms"] is not None
               else reports[name]["ms_events"]),
        "plain_ms": reports[name]["plain_ms"],
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
