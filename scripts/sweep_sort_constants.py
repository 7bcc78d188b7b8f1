#!/usr/bin/env python3
"""Times variants of the bin sort's constants on one NVIDIA GPU.

    python3 scripts/sweep_sort_constants.py [CHUNK,THREADS,TILE,CELLS,FAC]...

Builds copies of csrc/sort.cu with CHUNK (slots a place block sorts),
THREADS (its threads), SCAN_TILE (bins a scan block), TABLE_CELLS and
MAX_FACTOR (the (table chunk, bin) table's budget and the most chunks a
table chunk) replaced, with the port's flags into build/sweep_sort/, one
nvcc each and all at once; the default variants are the constants in
csrc/ and their neighbours. Each variant is held to the twin
(``binning.bin_sort_plain``, every output bitwise, ``pair_tri`` on the
valid prefix) and timed (the device time of each of its kernels a call,
torch.profiler, 50 calls) on the lists of the main rows at 1024x768: San
Miguel's and structured_scene.obj's cells (micro layout) and
structured_scene_tex.obj's tiles at 16x256 and 8x128 (flat layout, the
default capacities). Prints one ``[sweep]`` line a variant and list with
the card's name and power limit. The constants in csrc/ are the ones
this run prefers; the script changes no source.
"""

import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
OUT_DIR = os.path.join(ROOT, "build", "sweep_sort")
# (CHUNK, THREADS, SCAN_TILE, TABLE_CELLS, MAX_FACTOR)
VARIANTS = [(2048, 256, 128, 1 << 21, 4), (2048, 256, 128, 1 << 20, 8),
            (2048, 256, 64, 1 << 21, 4), (2048, 512, 128, 1 << 21, 4),
            (1024, 256, 128, 1 << 21, 4), (4096, 512, 128, 1 << 21, 4)]


def build(variants):
    """{variant: loaded library} of the variants that build."""
    from compute_renderer_torch import _build

    src = open(os.path.join(ROOT, "compute_renderer_torch", "csrc",
                            "sort.cu")).read()
    os.makedirs(OUT_DIR, exist_ok=True)
    procs = []
    for v in variants:
        s = src
        for name, value in zip(("CHUNK", "THREADS", "SCAN_TILE",
                                "TABLE_CELLS", "MAX_FACTOR"), v):
            s, k = re.subn(rf"constexpr int {name} = [^;]+;",
                           f"constexpr int {name} = {value};", s)
            assert k == 1, name
        stem = os.path.join(OUT_DIR, "v" + "_".join(map(str, v)))
        open(stem + ".cu", "w").write(s)
        procs.append((v, stem, subprocess.Popen(
            [_build.nvcc(), *_build.NVCC_FLAGS, "-o", stem + ".so",
             stem + ".cu"], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for v, stem, proc in procs:
        log = proc.communicate()[0]
        if proc.returncode:
            print(f"[sweep] {v}: build failed\n{log[-2000:]}")
            continue
        lib = ctypes.CDLL(stem + ".so")
        lib.bin_sort.argtypes = ([ctypes.c_void_p] * 16 + [ctypes.c_int] * 6
                                 + [ctypes.c_void_p])
        libs[v] = lib
    return libs


def lists(device):
    """(tag, keys, tris, total, num_bins, group, cap, meta, ntx) of the
    main rows' pair lists."""
    import chip_smoke as cs
    from compute_renderer_torch.backends import binning, cuda, expand, front

    scenes = cs.load_ext_scenes()
    out = []
    for tag, scene in (("san_miguel", cs.bench_scene(
            cs.SAN_MIGUEL, eye=cs.SAN_MIGUEL_EYE)),
            ("structured", cs.scene_copy(scenes["structured+textures"]))):
        x = cs.frame_inputs(scene, device)
        _, meta = front._front_end_cuda(x["pos_soa"], x["nrm_soa"], x["vp"],
                                        x["eff"], width=cs.W, height=cs.H,
                                        tile_h=8, tile_w=8)
        ntx_t, nty_t = (cs.W + 127) // 128, (cs.H + 7) // 8
        nb = ntx_t * nty_t * 16
        pc = cuda.grow_pair_cap(0, int(meta[3].sum()))
        k, t, tot = expand.expand_cells(meta[3], meta[2], meta[0], meta[1],
                                        pair_cap=pc, ntx_t=ntx_t,
                                        num_cells=nb)
        out.append((tag, k, t, tot, nb, 16, binning.CAP_NONE, None, 0))
    x = cs.frame_inputs(cs.scene_copy(scenes["structured_tex+textures"]),
                        device)
    for th, tw in cuda.TILE_CANDIDATES:
        _, meta = front._front_end_cuda(x["pos_soa"], x["nrm_soa"], x["vp"],
                                        x["eff"], width=cs.W, height=cs.H,
                                        tile_h=th, tile_w=tw)
        ntx, nty = -(-cs.W // tw), -(-cs.H // th)
        caps = cuda.default_caps("tile", x["T"], cs.W, cs.H, th, tw)
        k, t, tot = expand._expand_cuda(meta[3], meta[2], meta[0], meta[1],
                                        pair_cap=caps["pair_cap"], ntx_t=0,
                                        num_cells=ntx * nty, row_width=ntx)
        out.append((f"structured_tex {th}x{tw}", k, t, tot, ntx * nty, 1,
                    caps["tile_cap"], meta, ntx))
    return out


def scratch_ints(v, pair_cap, num_bins, rects):
    """``binning.sort_scratch_ints`` with the variant's constants."""
    chunk, _, tile, cells, factor = v
    wide = chunk
    while (wide < chunk * factor
           and max(-(-pair_cap // wide), 1) * num_bins > cells):
        wide *= 2
    chunks = max(-(-pair_cap // wide), 1)
    tiles = max(-(-num_bins // tile), 1)
    return (4 * tiles + (num_bins if rects else 0) + 2 * chunks
            + chunks * num_bins)


def run(lib, v, case, device):
    """The variant held to the twin on one list, then its kernels' device
    ms a call: {kernel: ms}."""
    import torch

    import chip_smoke as cs
    from compute_renderer_torch.backends import binning

    tag, keys, tris, total, nb, group, cap, meta, ntx = case
    pair_cap = keys.shape[0]
    scratch = torch.empty((scratch_ints(v, pair_cap, nb, meta is not None),),
                          dtype=torch.int32, device=device)
    nt = nb // group
    out = torch.empty((pair_cap,), dtype=torch.int32, device=device)
    seg = torch.empty((2, nb), dtype=torch.int32, device=device)
    wl = torch.empty((nt,), dtype=torch.int32, device=device)
    extra = torch.empty((2, nt), dtype=torch.int32, device=device)
    scal = torch.empty((5,), dtype=torch.int32, device=device)
    rows = ([None] * 4 if meta is None
            else [meta[i].contiguous() for i in (3, 2, 0, 1)])
    T = 0 if meta is None else meta.shape[1]
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731

    def call():
        rc = lib.bin_sort(
            keys.data_ptr(), tris.data_ptr(), total.data_ptr(),
            *(ptr(r) for r in rows), scratch.data_ptr(), out.data_ptr(),
            seg[0].data_ptr(), seg[1].data_ptr(),
            extra[0].data_ptr() if group == 16 else None,
            extra[1].data_ptr() if group == 16 else None, wl.data_ptr(),
            scal.data_ptr(), None, T, pair_cap, nb, group, cap, ntx,
            torch.cuda.current_stream(device).cuda_stream)
        cs.require(rc == 0, f"{v} {tag}: CUDA error {rc} at launch")

    call()
    torch.cuda.synchronize()
    exact = None
    if meta is not None:
        exact = binning.exact_tile_counts(binning.setup_from_meta(meta), ntx,
                                          nb // ntx)
    want = binning.bin_sort_plain(keys, tris, total, nb, group=group,
                                  cap=cap, exact=exact)
    got = {"pair_tri": out, "seg_start": seg[0], "seg_count": seg[1],
           "worklist": wl, "k": scal[3], "total_pairs": scal[2],
           "pair_needed": scal[0], "tile_needed": scal[1],
           "most": scal[4], "overflow": scal[0:2]}
    if group == 16:
        got["tile_count"], got["win_start"] = extra[0], extra[1]
    cs.compare_bins(f"{v} {tag}", got, want, min(int(total), pair_cap))
    return {cs.short_name(k): ms for k, (ms, _) in
            cs.kernel_split_ms(call, 50, "bin_sort_").items()}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("sweep_sort_constants: needs a CUDA card", file=sys.stderr)
        return 3
    from compute_renderer_torch import _build
    from compute_renderer_torch.bench.profiling import card_line

    variants = ([tuple(int(x) for x in a.split(",")) for a in sys.argv[1:]]
                or VARIANTS)
    _build.build_all(["front", "expand"])
    libs = build(variants)
    device = torch.device("cuda:0")
    card = card_line()
    cases = lists(device)
    for v, lib in libs.items():
        for case in cases:
            split = run(lib, v, case, device)
            print(f"[sweep] {v} {case[0]}: {sum(split.values()):.6f} ms ("
                  + "; ".join(f"{k} {ms:.6f}" for k, ms in split.items())
                  + f") ; card: {card}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
