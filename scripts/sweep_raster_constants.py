#!/usr/bin/env python3
"""Times the two rasters' source constants on one NVIDIA GPU.

    python3 scripts/sweep_raster_constants.py [--probe | --short]

Builds copies of csrc/raster.cu (the 16-row tiles' SUB_H_TALL x SUB_W_TALL
blocks, WARPS, MIN_BLOCKS) and
csrc/micro.cu (SPAN, WARPS) with their constants replaced, one nvcc
each and all at once, into build/sweep/, then for each variant: checks it
against the twin (keys and outputs bitwise) and prints its device time
(torch.profiler, every launch of a call) in two passes, the variants in
order and then reversed. The inputs are chip_smoke.py's: the tile raster
on structured_scene_tex.obj (mat mode, flat) and bench.py's Suzanne frame
(base, dense), the micro raster on structured_scene.obj (mat mode), all at
1024x768; the 8-row tiles' blocks (SHORT_VARIANTS; alone with --short)
on the structured_tex_aniso.batch cell's frame. The span length is
csrc/tile_span.cuh's, which the bin sort shares, and is not varied.
Writes chiprun_out/sweep_raster_constants.json. The constants in
csrc/ are the ones this run prefers; the script changes no source. Then
(alone with --probe) the csrc/ kernels on cut-down lists (``probe``) and
a stamped copy of the tile raster (``timeline``): what sets each raster's
time; the probe also times the structured_tex_aniso.batch cell's frame
(texf_mip, anisotropic, flat, 8x128).
"""

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TILE_VARIANTS = [  # (SUB_H_TALL, SUB_W_TALL, WARPS, MIN_BLOCKS)
    (16, 32, 8, 4), (8, 16, 8, 4), (8, 32, 8, 4), (8, 8, 8, 4),
    (16, 16, 8, 4), (16, 32, 16, 2), (8, 16, 4, 8), (8, 8, 4, 8)]
# The 8-row tiles' blocks (timed on the 8x128 frame alone; with --short,
# these variants alone): (SUB_W_SHORT, WARPS, MIN_BLOCKS).
SHORT_VARIANTS = [(32, 8, 4), (16, 8, 4), (64, 8, 4), (32, 4, 8)]
MICRO_VARIANTS = [  # (SPAN, WARPS)
    (128, 4), (64, 4), (256, 4), (128, 8)]


def variant_source(name, values):
    """csrc/<name>.cu with its constants replaced."""
    from compute_renderer_torch import _build

    text = (_build.CSRC / f"{name}.cu").read_text()
    for const, value in values.items():
        text, n = re.subn(rf"constexpr int {const} = [^;]+;",
                          f"constexpr int {const} = {value};", text)
        if n != 1:
            raise SystemExit(f"{name}.cu: no single {const} constant")
    return text


def build_variant(name, tag, values):
    """Compiles a variant with the port's flags; returns (tag, library,
    ptxas line)."""
    from compute_renderer_torch import _build

    out_dir = os.path.join(ROOT, "build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"{name}_{tag}.cu")
    with open(src, "w") as fh:  # beside csrc/'s headers via -I
        fh.write(variant_source(name, values))
    lib = os.path.join(out_dir, f"lib{name}_{tag}.so")
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc {name} {tag}:\n{proc.stdout}{proc.stderr}")
    sys.path.insert(0, ROOT)
    import chip_smoke

    report = chip_smoke.ptxas_report(proc.stdout + proc.stderr)
    return tag, lib, "; ".join(f"{k} {v}" for k, v in sorted(report.items())
                               if k.endswith("<1>") or k.endswith("<0>")
                               or k.startswith("raster_kernel<4"))


def install(name, symbol, lib, pointers, ints):
    """Makes the wrappers launch ``symbol`` of ``lib``."""
    import ctypes

    from compute_renderer_torch import _build

    fn = getattr(ctypes.CDLL(lib), symbol)
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * ints
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _build._ENTRIES[(name, symbol)] = fn


def probe(cases, run):
    """What sets each raster's time, with the source's own constants: the
    same launch on lists cut down (the work list and the span list are
    rebuilt from the counts, so a tile or cell counted 0 is left out).
    Tile raster: the heaviest tile alone, every tile but the four
    heaviest, every list cut to its first 256 triangles and to its first
    (the blocks' fixed cost), and no tile at all (the launch and the
    exiting blocks). Micro raster:
    every cell cut to SPAN pairs (no spans), the cells over SPAN pairs
    alone, every cell cut to 16 pairs."""
    import torch

    import chip_smoke as cs
    from compute_renderer_torch import _build
    from compute_renderer_torch.backends import micro

    _build._ENTRIES.clear()  # the csrc/ kernels again
    for case, (kind, args, kw) in cases.items():
        if case == "tile suzanne base":
            continue
        counts = args[3]
        top = torch.argsort(counts, descending=True)
        if kind == "raster":
            cuts = {"heaviest tile alone": torch.where(
                        torch.arange(counts.numel(), device=counts.device)
                        == top[0], counts, 0),
                    "all but the 4 heaviest": counts.index_fill(
                        0, top[:4], 0),
                    "lists cut to 256": counts.clamp(max=256),
                    "lists cut to 1": counts.clamp(max=1),
                    "no tile": torch.zeros_like(counts)}
        else:
            span = micro.SPAN
            cuts = {"cells cut to SPAN (no spans)": counts.clamp(max=span),
                    "cells over SPAN alone": torch.where(counts > span,
                                                         counts, 0),
                    "cells cut to 16": counts.clamp(max=16)}
        symbol = f"{kind}_kernel"
        full = cs.kernel_device_ms(lambda: run(kind, args, kw), 30, symbol)
        print(f"[probe] {case}: full {full:.6f} ms, longest "
              f"{int(counts.max())}, pairs {int(counts.sum())}")
        for label, cut in cuts.items():
            cut = cut.to(counts.dtype)
            a = list(args)
            a[3] = cut
            if kind == "micro":  # the tiles' counts follow the cells'
                a[4] = cut.reshape(-1, 16).sum(1).to(args[4].dtype)
            ms = cs.kernel_device_ms(lambda: run(kind, tuple(a), kw), 30,
                                     symbol)
            print(f"[probe] {case}: {label}: {ms:.6f} ms, longest "
                  f"{int(cut.max())}, pairs {int(cut.sum())}")


# Where the timeline copy of raster.cu stamps %globaltimer: (text in the
# kernel, stamp inserted after it). Round c's four stamps are 2 + 4 c to
# 5 + 4 c: staged, culled, items listed, walked; the last, a whole list's
# pixels emitted or a span's words folded.
STAMPS = [
    ("  const int ti = tile / ntx;\n", "STAMP(0)"),
    ("warp_rects[warp] = patch;\n  }\n  __syncthreads();\n", "STAMP(1)"),
    ("    __syncthreads();  // and every thread's\n", "STAMP(2 + 4 * c)"),
    ("= threadIdx.x;\n    __syncthreads();\n", "STAMP(3 + 4 * c)"),
    ("item_counts[warp] = listed;\n    __syncthreads();\n",
     "STAMP(4 + 4 * c)"),
    ("    __syncthreads();  // round c is consumed before its buffer is "
     "refilled\n", "STAMP(5 + 4 * c)"),
    ("        emit(p, j, r, cl, words[p * 64 + lane + 32 * j]);\n    }\n",
     "STAMP(1023)"),
    ("    if (v != WORD_CLEAR) atomicMin(global_word(r, cl), v);\n  }\n",
     "STAMP(1023)"),
]


def timeline(cases):
    """The heaviest tile's first block, stamped: a copy of csrc/raster.cu
    in which thread 0 of sub-rectangle 0 of span 0 of a tile of at least
    the heaviest list's count records %globaltimer at the kernel's start,
    after the set-up barrier, after each round's four barriers and after
    its words are folded (a span block's epilogue waits on the last span
    to arrive); printed as microseconds per step."""
    import ctypes

    import torch

    from compute_renderer_torch import _build
    from compute_renderer_torch.backends import binning, raster

    kind, args, kw = cases["tile structured_tex mat"]
    heaviest = int(args[3].max())
    text = (_build.CSRC / "raster.cu").read_text()
    for anchor, stamp in STAMPS:
        if text.count(anchor) != 1:
            raise SystemExit(f"timeline: anchor not unique: {anchor!r}")
        text = text.replace(anchor, anchor + f"  {stamp};\n")
    text = text.replace("namespace {\n", f"""namespace {{
__device__ unsigned long long probe_stamp[1024];
#define STAMP(i) \\
    if (threadIdx.x == 0 && sub == 0 && lo == 0 && count >= {heaviest}) \\
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(probe_stamp[(i)]))
""", 1)
    text += """
extern "C" int read_probe(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, probe_stamp, sizeof(probe_stamp));
}
"""
    out_dir = os.path.join(ROOT, "build", "sweep")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, "raster_timeline.cu")
    with open(src, "w") as fh:
        fh.write(text)
    lib = os.path.join(out_dir, "libraster_timeline.so")
    proc = subprocess.run(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o",
         lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc timeline:\n{proc.stdout}{proc.stderr}")
    install("raster", "raster_shade_tiles", lib, 13, 11)
    read = ctypes.CDLL(lib).read_probe
    read.argtypes = [ctypes.c_void_p]
    stamps = torch.zeros(1024, dtype=torch.int64)
    for _ in range(3):  # the last of three launches
        raster._raster_cuda(*args, worklist=binning.occupied_worklist(
            args[3]), spans=binning.span_list_plain(args[3],
                                                    args[1].shape[0]), **kw)
    torch.cuda.synchronize()
    if read(stamps.data_ptr()) != 0:
        raise SystemExit("timeline: read_probe failed")
    t = stamps.tolist()
    rounds = -(-min(heaviest, binning.TILE_SPAN) // 256)
    us = lambda a, b: (t[b] - t[a]) / 1e3
    print(f"[timeline] heaviest tile ({heaviest} triangles, {rounds} rounds)"
          f", block 0: set-up {us(0, 1):.2f} us, epilogue "
          f"{us(5 + 4 * (rounds - 1), 1023):.2f} us, total "
          f"{us(0, 1023):.2f} us")
    for c in range(rounds):
        prev = 1 if c == 0 else 5 + 4 * (c - 1)
        print(f"[timeline]   round {c}: staged {us(prev, 2 + 4 * c):.2f}, "
              f"culled {us(2 + 4 * c, 3 + 4 * c):.2f}, listed "
              f"{us(3 + 4 * c, 4 + 4 * c):.2f}, walked "
              f"{us(4 + 4 * c, 5 + 4 * c):.2f} us")
    _build._ENTRIES.clear()


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("sweep: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from compute_renderer_torch.backends import binning, cuda, micro, raster

    device = torch.device("cuda:0")
    from compute_renderer_torch.bench.profiling import card_line

    card = card_line()
    print(f"[device] {card}")
    short = "--short" in sys.argv
    jobs = [("raster", f"{h}x{w}_w{n}_b{b}",
             {"SUB_H_TALL": h, "SUB_W_TALL": w, "WARPS": n,
              "MIN_BLOCKS": b})
            for h, w, n, b in TILE_VARIANTS]
    jobs += [("micro", f"span{s}_w{w}", {"SPAN": s, "WARPS": w})
             for s, w in MICRO_VARIANTS]
    if short:
        jobs = []
    jobs += [("raster", f"8x{w}_w{n}_b{b}",
              {"SUB_W_SHORT": w, "WARPS": n, "MIN_BLOCKS": b})
             for w, n, b in SHORT_VARIANTS]
    if "--probe" in sys.argv:
        jobs = []
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=max(len(jobs), 1)) as pool:
        built = list(pool.map(lambda j: (j[0],) + build_variant(*j), jobs))
    print(f"[build] {len(built)} variants in {time.perf_counter() - t0:.1f} s")

    # Inputs, as chip_smoke.py's phases 3 and 9 build them.
    scenes = cs.load_ext_scenes()
    cases = {}
    x = cs.frame_inputs(cs.scene_copy(scenes["structured_tex+materials"]),
                        device)
    table, meta = cs.check_front("structured_tex", x, False, {}, mode="mat")
    ntx, nty = (cs.W + 255) // 256, (cs.H + 15) // 16
    setup = binning.setup_from_meta(meta)
    need = binning.exact_tile_counts(setup, ntx, nty)
    bins = binning.bin_triangles_sort(setup, ntx, nty, int(need.sum()),
                                      int(need.max()))
    params, lights = raster.shading_inputs(x["eff"], x["vpos"], x["lwp"],
                                           x["lc"], x["li"])
    tkw = dict(height_padded=nty * 16, width_padded=ntx * 256, tile_h=16,
               tile_w=256, layout="flat", mode="mat")
    cases["tile structured_tex mat"] = ("raster", (
        table, bins["pair_tri"], bins["seg_start"],
        bins["seg_count"], params, lights), tkw)
    # The structured_tex_aniso.batch cell's frame: the 36k scene at its
    # spawn, texf_mip under the anisotropic filter, the flat layout at the
    # tuner's 8x128.
    x = cs.frame_inputs(cs.scene_copy(scenes["structured_tex+textures"]),
                        device, tex_filter="anisotropic")
    table, meta = cs.check_front("structured_tex", x, False, {},
                                 tile=(8, 128), mode="texf_mip")
    ntx8, nty8 = (cs.W + 127) // 128, (cs.H + 7) // 8
    setup = binning.setup_from_meta(meta)
    need = binning.exact_tile_counts(setup, ntx8, nty8)
    bins = binning.bin_triangles_sort(setup, ntx8, nty8, int(need.sum()),
                                      int(need.max()))
    params, lights = raster.shading_inputs(x["eff"], x["vpos"], x["lwp"],
                                           x["lc"], x["li"])
    cases["tile structured_tex texf_mip 8x128"] = ("raster", (
        table, bins["pair_tri"], bins["seg_start"], bins["seg_count"],
        params, lights), dict(height_padded=nty8 * 8,
                              width_padded=ntx8 * 128, tile_h=8,
                              tile_w=128, layout="flat", mode="texf_mip"))
    x = cs.frame_inputs(cs.bench_scene(), device)
    table, meta = cs.check_front("suzanne", x, False, {})
    setup = binning.setup_from_meta(meta)
    need = binning.exact_tile_counts(setup, ntx, nty)
    bins = binning.bin_triangles_dense(setup, ntx, nty, int(need.sum()),
                                       int(need.max()))
    params, lights = raster.shading_inputs(x["eff"], x["vpos"], x["lwp"],
                                           x["lc"], x["li"])
    cases["tile suzanne base"] = ("raster", (
        table, bins["bin_rows"], bins["seg_start"],
        bins["seg_count"], params, lights), dict(tkw, layout="dense",
                                                 mode="base"))
    x = cs.frame_inputs(cs.scene_copy(scenes["structured+materials"]),
                        device)
    table, meta = cs.check_front("structured", x, False, {}, tile=(8, 8),
                                 mode="mat")
    mtx, mty = (cs.W + 127) // 128, (cs.H + 7) // 8
    pair_cap = cuda.grow_pair_cap(0, max(int(meta[3].sum()),
                                         mtx * mty * 16, 1024))
    bins = binning.bin_cells_sort_meta(meta[3], meta[2], meta[0], meta[1],
                                       mtx, mty, pair_cap)
    params, lights = raster.shading_inputs(x["eff"], x["vpos"], x["lwp"],
                                           x["lc"], x["li"])
    cases["micro structured mat"] = ("micro", (
        table, bins["pair_tri"], bins["seg_start"],
        bins["seg_count"], bins["tile_count"], params, lights),
        dict(height_padded=mty * 8, width_padded=mtx * 128, mode="mat"))

    def run(kind, args, kw):
        if kind == "raster":  # with the flat layout's span list
            spans = None
            if kw["layout"] == "flat":
                spans = binning.span_list_plain(args[3], args[1].shape[0])
            wl = binning.occupied_worklist(args[3])
            return raster._raster_cuda(*args, worklist=wl, spans=spans, **kw)
        return micro._micro_cuda(*args, **kw)

    def twin(kind, args, kw):
        if kind == "raster":
            return raster.raster_shade_tiles_plain(*args, **kw)
        return micro.raster_shade_micro_plain(*(args[:4] + args[5:]), **kw)

    expected = {name: twin(*case) for name, case in cases.items()}
    results = {}
    for order in (built, built[::-1]) if "--probe" not in sys.argv else ():
        for name, tag, lib, ptxas in order:
            symbol = ("raster_shade_tiles" if name == "raster"
                      else "raster_shade_micro")
            install(name, symbol, lib, *((13, 11) if name == "raster"
                                         else (14, 7)))
            tall = not tag.startswith("8x") or name != "raster"
            for case, (kind, args, kw) in cases.items():
                if kind != name or (kw.get("tile_h") == 8) == tall:
                    continue
                out, key = run(kind, args, kw)
                ref_out, ref_key = expected[case]
                same = (torch.equal(key, ref_key) and torch.equal(
                    raster.defined_planes(out, key).view(torch.int32),
                    raster.defined_planes(ref_out, ref_key).view(
                        torch.int32)))
                if not same:
                    raise SystemExit(f"{name} {tag} differs from the twin "
                                     f"on {case}")
                ms = cs.kernel_device_ms(lambda: run(kind, args, kw), 30,
                                         f"{name}_kernel")
                results.setdefault(f"{case} | {tag}", {
                    "ptxas": ptxas, "ms": []})["ms"].append(ms)
                print(f"[sweep] {case:24s} {tag:12s} {ms:.6f} ms "
                      f"(bitwise with the twin) | {ptxas}")
    if not short:
        probe(cases, run)
        timeline(cases)
    print(f"[sweep] card: {card}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out",
                           "sweep_raster_constants.json"), "w") as fh:
        json.dump({"card": card, "results": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
