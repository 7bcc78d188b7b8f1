#!/usr/bin/env python3
"""Times the pair expansion's block shapes on one NVIDIA GPU, and where
its time goes.

    python3 scripts/sweep_expand_blocks.py

Builds copies of csrc/expand.cu with its block shape replaced (THREADS x
ITEMS triangles a block, MIN_BLOCKS resident an SM) and one that loads
the rect of every triangle instead of the live ones' only, with the
port's flags into build/sweep_expand/, one nvcc each and all at once.
Each variant is checked against the twin (pairs bitwise on the valid
range, the sentinel tail, the total) and timed in turns (the variants in
order, then reversed; the device time of both launches of a call,
torch.profiler) on the meta of the micro path's frames at 1024x768, 8x8
cells: the San Miguel stand-in and structured_scene.obj. Then
(``timeline``) a copy of csrc/expand.cu stamped with ``%globaltimer`` at
each phase of each block (start, range staged, scan, block sums added,
slots filled, tail written) runs on each frame's meta: the launch's span,
when the blocks start, and each phase's time, for the median and the
slowest block. Writes chiprun_out/sweep_expand_blocks.json. The constants
in csrc/ are the ones this run prefers; the script changes no source.
"""

import ctypes
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT_DIR = os.path.join(ROOT, "build", "sweep_expand")
# The variants: (THREADS, ITEMS, MIN_BLOCKS, whose rects a block loads:
# the "live" triangles' only, as csrc/ has it, or "all").
EXPAND_VARIANTS = [(256, 4, 8, "live"), (256, 4, 6, "live"),
                   (256, 4, 8, "all"), (256, 8, 4, "live"),
                   (128, 8, 10, "live"), (128, 4, 16, "live"),
                   (256, 2, 8, "live")]


def nvcc_build(src_text, tag):
    """Compiles a source text with the port's flags, beside csrc/'s headers;
    returns (library, ptxas line)."""
    import chip_smoke
    from compute_renderer_torch import _build

    os.makedirs(OUT_DIR, exist_ok=True)
    src = os.path.join(OUT_DIR, f"{tag}.cu")
    with open(src, "w") as fh:
        fh.write(src_text)
    lib = os.path.join(OUT_DIR, f"lib{tag}.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I",
                           str(_build.CSRC), "-o", lib, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc {tag}:\n{proc.stdout}{proc.stderr}")
    report = chip_smoke.ptxas_report(proc.stdout + proc.stderr)
    return lib, "; ".join(f"{k} {v}" for k, v in sorted(report.items()))


def c_fn(lib, symbol, pointers, ints):
    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def expand_variant(threads, items, min_blocks, loads):
    """csrc/expand.cu with its block shape and resident blocks replaced,
    loading the rects of the live triangles or of all."""
    from compute_renderer_torch import _build

    text = (_build.CSRC / "expand.cu").read_text()
    for name, value in (("THREADS", threads), ("ITEMS", items),
                        ("MIN_BLOCKS", min_blocks)):
        text, n = re.subn(rf"constexpr int {name} = \d+;",
                          f"constexpr int {name} = {value};", text)
        assert n == 1, name
    if loads == "all":
        text, n = re.subn(r"if \(ci > 0\) \{", "if (i < n) {", text)
        assert n == 1, loads
    return text


STAMP_HEAD = r"""
#include <cuda_runtime.h>
__device__ unsigned long long g_stamp[8 * 65536];
// Block-wide barrier, then thread 0 stamps phase k of its block.
__device__ __forceinline__ void stamp(int k) {
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    g_stamp[8 * blockIdx.x + k] = t;
  }
}
extern "C" int read_stamps(void* host, int blocks) {
  return (int)cudaMemcpyFromSymbol(host, g_stamp, (size_t)blocks * 64);
}
"""
# The phases of expand_kernel a stamp ends, by the source comment that
# starts the next one (the last stamp closes the kernel).
STAMP_BEFORE = ("  // Stage the range", "  // Local exclusive scan",
                "  // The block's first slot", "  // Fill the block's slots",
                "  // This block's share of the sentinel tail")
PHASES = ("staged", "scanned", "block sums", "filled", "tail")


def stamped_expand():
    """csrc/expand.cu with a stamp before each phase of expand_kernel and
    at its end."""
    from compute_renderer_torch import _build

    text = (_build.CSRC / "expand.cu").read_text()
    text = text.replace("#include <cuda_runtime.h>", STAMP_HEAD, 1)
    for k, marker in enumerate(STAMP_BEFORE):
        assert text.count(marker) == 1, marker
        text = text.replace(marker, f"  stamp({k});\n{marker}")
    end = "\n}\n\n}  // namespace"
    assert text.count(end) == 1
    return text.replace(end, f"\n  stamp({len(STAMP_BEFORE)});{end}")


def timeline(lib, tris, meta, pair_cap, ntx, num_cells, tag):
    """Runs the stamped expansion on ``meta`` and prints the launch's span,
    the spread of the blocks' starts, and each phase's time for the
    median and the slowest block (ns, %globaltimer)."""
    import numpy as np
    import torch

    T = meta.shape[1]
    blocks = -(-T // tris)
    fn = c_fn(lib, "expand_rows_i32", 8, 5)
    read = getattr(ctypes.CDLL(lib), "read_stamps")
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    sums = torch.empty((blocks,), dtype=torch.int32, device=meta.device)
    total = torch.empty((1,), dtype=torch.int32, device=meta.device)
    cell = torch.empty((pair_cap,), dtype=torch.int32, device=meta.device)
    tri = torch.empty((pair_cap,), dtype=torch.int32, device=meta.device)
    for _ in range(3):  # the last launch's stamps are read
        status = fn(meta[3].data_ptr(), meta[2].data_ptr(),
                    meta[0].data_ptr(), meta[1].data_ptr(), sums.data_ptr(),
                    total.data_ptr(), cell.data_ptr(), tri.data_ptr(), T,
                    blocks, pair_cap, 16 * ntx, num_cells,
                    torch.cuda.current_stream().cuda_stream)
        assert status == 0, status
    torch.cuda.synchronize()
    stamps = np.zeros((blocks, 8), np.uint64)
    assert read(stamps.ctypes.data, blocks) == 0
    t = stamps[:, :len(STAMP_BEFORE) + 1].astype(np.int64)
    t -= t[:, 0].min()
    phases = np.diff(t, axis=1)
    slots = sums.cpu().numpy()
    slow = int(np.argmax(t[:, -1]))
    pct = lambda a: [int(np.percentile(a, q)) for q in (50, 90, 100)]
    out = {"blocks": blocks, "span_ns": int(t[:, -1].max()),
           "start_ns_p50_p90_max": pct(t[:, 0]),
           "block_ns_p50_p90_max": pct(t[:, -1] - t[:, 0]),
           "phase_ns_p50_p90_max": {p: pct(phases[:, k])
                                    for k, p in enumerate(PHASES)},
           "slowest": {"block": slow, "slots": int(slots[slow]),
                       "start_ns": int(t[slow, 0]),
                       "phase_ns": {p: int(phases[slow, k])
                                    for k, p in enumerate(PHASES)}},
           "slots_p50_max": [int(np.median(slots)), int(slots.max())]}
    print(f"[timeline] {tag}: {json.dumps(out)}")
    return out


def device_ms(fn, iters):
    """(ms a call, {kernel: ms a call}): the device time of every kernel
    ``fn`` launches, from torch.profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    kernels = {}
    for ev in prof.key_averages():
        if getattr(ev, "device_type", None) != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(ev, "self_device_time_total", None)
        if t is None:
            t = getattr(ev, "self_cuda_time_total", 0)
        if t:
            kernels[ev.key[:70]] = t / iters / 1e3
    return sum(kernels.values()), kernels


def in_turns(runs, iters):
    """Times {name: fn} in turns: the order, then reversed. Returns {name:
    (mean ms, [turns], kernels of the last turn)}."""
    names = list(runs)
    out = {name: [] for name in names}
    kernels = {}
    for name in names + names[::-1]:
        ms, kernels[name] = device_ms(runs[name], iters)
        out[name].append(ms)
    return {name: (sum(v) / len(v), v, kernels[name])
            for name, v in out.items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from compute_renderer_torch.backends import cuda, expand, front

    device = torch.device("cuda:0")
    from compute_renderer_torch.bench.profiling import card_line

    card = card_line()
    print(f"[device] {torch.cuda.get_device_name(0)} | {card}")
    sources = {f"{threads}x{items}_{min_blocks}_{loads}": expand_variant(
        threads, items, min_blocks, loads)
        for threads, items, min_blocks, loads in EXPAND_VARIANTS}
    sources["stamped"] = stamped_expand()
    with ThreadPoolExecutor(max_workers=len(sources)) as pool:
        futures = {tag: pool.submit(nvcc_build, text, tag)
                   for tag, text in sources.items()}
        libs = {tag: f.result() for tag, f in futures.items()}
    for tag, (_, ptxas) in libs.items():
        print(f"[build] {tag}: {ptxas}")
    stream = lambda: torch.cuda.current_stream(device).cuda_stream
    report = {"card": card, "expand": {}, "timeline": {}}

    def pairs(fn, tris, meta, pair_cap, ntx, num_cells):
        T = meta.shape[1]
        blocks = -(-T // tris)
        sums = torch.empty((blocks,), dtype=torch.int32, device=device)
        total = torch.empty((1,), dtype=torch.int32, device=device)
        cell = torch.empty((pair_cap,), dtype=torch.int32, device=device)
        tri = torch.empty((pair_cap,), dtype=torch.int32, device=device)
        status = fn(meta[3].data_ptr(), meta[2].data_ptr(),
                    meta[0].data_ptr(), meta[1].data_ptr(), sums.data_ptr(),
                    total.data_ptr(), cell.data_ptr(), tri.data_ptr(), T,
                    blocks, pair_cap, 16 * ntx, num_cells, stream())
        cs.require(status == 0, f"expand variant: CUDA error {status}")
        return cell, tri, total[0]

    scenes = cs.load_ext_scenes()
    cases = (("san_miguel", cs.bench_scene(cs.SAN_MIGUEL,
                                           eye=cs.SAN_MIGUEL_EYE)),
             ("structured", scenes["structured+materials"]))
    ntx, nty = (cs.W + 127) // 128, (cs.H + 7) // 8
    num_cells = ntx * nty * 16
    for name, scene in cases:
        x = cs.frame_inputs(scene, device)
        _, meta = front._front_end_cuda(
            x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"], width=cs.W,
            height=cs.H, tile_h=8, tile_w=8)
        total = int(meta[3].sum())
        alive = int((meta[3] > 0).sum())
        pair_cap = cuda.grow_pair_cap(0, total)
        ref = expand.expand_cells_plain(
            meta[3], meta[2], meta[0], meta[1], pair_cap=pair_cap,
            ntx_t=ntx, num_cells=num_cells)
        runs = {}
        for threads, items, min_blocks, loads in EXPAND_VARIANTS:
            tag = f"{threads}x{items}_{min_blocks}_{loads}"
            fn = c_fn(libs[tag][0], "expand_rows_i32", 8, 5)
            runs[f"{threads}x{items}, {min_blocks} an SM, {loads} rects"] = (
                lambda fn=fn, tris=threads * items: pairs(
                    fn, tris, meta, pair_cap, ntx, num_cells))
        n = min(total, pair_cap)
        for k, run in runs.items():
            cell, tri, tot = run()
            torch.cuda.synchronize()
            cs.require(int(tot) == total
                       and torch.equal(cell[:n], ref[0][:n])
                       and torch.equal(tri[:n], ref[1][:n])
                       and bool((cell[n:] == num_cells).all()),
                       f"{name} expand {k}: differs from the twin")
        res = in_turns(runs, 50)
        report["expand"][name] = res
        # chip_smoke.py's bound: each count, the live triangles' rects,
        # 8 B a slot.
        bound = cs.bound_ms(x["T"] * 4 + alive * 12 + pair_cap * 8, 0)[0]
        for k, (ms, turns, kernels) in res.items():
            print(f"[expand] {name} T={x['T']} live={alive} pairs={total} "
                  f"pair_cap={pair_cap}: {k}: {ms:.6f} ms "
                  f"({bound / ms:.2f} of the {bound:.6f} ms bound; turns "
                  f"{[round(t, 6) for t in turns]}; {kernels})")
        report["timeline"][name] = timeline(
            libs["stamped"][0], expand.TRIS, meta, pair_cap, ntx,
            num_cells, name)
    print(f"[sweep] card: {card}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "sweep_expand_blocks.json"),
              "w") as fh:
        json.dump(report, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
