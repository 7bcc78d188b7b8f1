#!/usr/bin/env python3
"""Times the micro raster kernel (csrc/micro.cu) against another tree's,
and variants of its constants, on one NVIDIA GPU.

    python3 scripts/compare_micro.py [--parent DIR] [--variants] [--rounds N]

Builds this tree's csrc/micro.cu, the parent tree's
(DIR/compute_renderer_torch/csrc/micro.cu with its own headers) and, with
--variants, copies of this tree's with SPAN, WARPS or WIDE replaced
(VARIANTS), one nvcc each and all at once, into
build/compare_micro/. The
inputs are chip_smoke.py's at 1024x768 on the micro path: San Miguel
(base), the structured scene in the five modes, san_miguel_small under
voxelize and Suzanne under mirage. For each case every build's key and
output bits must equal this tree's kernel's (a G-buffer's planes where
the key is set: they are undefined elsewhere), this tree's kernel must
equal the twin (keys bitwise) and count the twin's samples; then each
build's device time of every kernel named micro_kernel* a call launches
(torch.profiler, 20 calls) in N rounds (default 2) of the builds in
order and then reversed. Prints each
build's ptxas line and writes chiprun_out/compare_micro.json. The script
changes no source.
"""

import json
import os
import re
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
VARIANTS = [  # constants of csrc/micro.cu replaced, around the source's
    {"SPAN": 64}, {"SPAN": 256}, {"WARPS": 8}, {"WARPS": 16}, {"WIDE": 2},
    {"WIDE": 6}]


def build(tag, source, include):
    """Compiles ``source`` (text) with the port's flags against the
    headers of ``include``; returns (tag, library, ptxas lines, pointers
    its entry takes)."""
    sys.path.insert(0, ROOT)
    import chip_smoke as cs
    from compute_renderer_torch import _build

    out_dir = os.path.join(ROOT, "build", "compare_micro")
    os.makedirs(out_dir, exist_ok=True)
    src = os.path.join(out_dir, f"micro_{tag}.cu")
    with open(src, "w") as fh:
        fh.write(source)
    lib = os.path.join(out_dir, f"libmicro_{tag}.so")
    proc = subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-I", include,
                           "-o", lib, src], capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc {tag}:\n{proc.stdout}{proc.stderr}")
    head = source[source.index('extern "C" int raster_shade_micro('):]
    pointers = head[:head.index(")")].count("void*") - 1  # not the stream
    report = cs.ptxas_report(proc.stdout + proc.stderr)
    return tag, lib, "; ".join(f"{k} {v}" for k, v in sorted(report.items())
                               if "micro_kernel" in k), pointers


def variant(text, values):
    for const, value in values.items():
        text, n = re.subn(rf"constexpr int {const} = [^;]+;",
                          f"constexpr int {const} = {value};", text)
        if n != 1:
            raise SystemExit(f"micro.cu: no single {const} constant")
    return text


def load(lib, pointers):
    import ctypes

    fn = ctypes.CDLL(lib).raster_shade_micro
    fn.argtypes = ([ctypes.c_void_p] * pointers + [ctypes.c_int] * 7
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def cases(device):
    """{name: (table, bins, params, lights, mode)} at 1024x768."""
    import chip_smoke as cs
    from compute_renderer_torch.backends import binning, cuda, raster
    from compute_renderer_torch.core.effects import Effect

    ntx, nty = (cs.W + 127) // 128, (cs.H + 7) // 8

    def micro_case(x, mode):
        fmode = "base" if mode == "vis" else mode
        table, meta = cs.check_front(f"compare {mode}", x, False, {},
                                     tile=(8, 8), mode=fmode)
        cap = cuda.grow_pair_cap(0, max(int(meta[3].sum()), ntx * nty * 16,
                                        1024))
        bins = binning.bin_cells_sort_meta(meta[3], meta[2], meta[0],
                                           meta[1], ntx, nty, cap)
        params, lights = raster.shading_inputs(x["eff"], x["vpos"], x["lwp"],
                                               x["lc"], x["li"])
        return table, bins, params, lights, mode

    out = {}
    for name, model, effect, eye in (
            ("san_miguel", cs.SAN_MIGUEL, None, cs.SAN_MIGUEL_EYE),
            ("san_miguel_small+voxelize", "san_miguel_small.obj",
             Effect.voxelize(0.5, 1.0), cs.SAN_MIGUEL_EYE),
            ("suzanne+mirage", "suzanne.obj", Effect.mirage(0.6, 0.7, 0.3),
             (0.0, 0.0, 3.0))):
        scene = cs.bench_scene(model, effect, eye)
        for _ in range(3):
            scene.update(cs.DT)
        out[f"{name} base"] = micro_case(cs.frame_inputs(scene, device),
                                         "base")
    scenes = cs.load_ext_scenes()
    for mode in ("base",) + cs.MODES + cs.NEW_MODES:
        x = cs.frame_inputs(cs.scene_copy(scenes["structured+textures"]),
                            device, **cs.MODE_OPTIONS.get(mode, {}))
        out[f"structured {mode}"] = micro_case(x, mode)
    return out


def main() -> int:
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("compare_micro: needs an NVIDIA GPU", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from compute_renderer_torch import _build
    from compute_renderer_torch.backends import binning, common, micro, raster
    from compute_renderer_torch.bench.profiling import card_line

    args = sys.argv[1:]
    parent = args[args.index("--parent") + 1] if "--parent" in args else None
    rounds = int(args[args.index("--rounds") + 1]) if "--rounds" in args \
        else 2
    device = torch.device("cuda:0")
    card = card_line()
    print(f"[device] {card}")
    text = (_build.CSRC / "micro.cu").read_text()
    jobs = [("tree", text, str(_build.CSRC))]
    if parent:
        pdir = os.path.join(parent, "compute_renderer_torch", "csrc")
        with open(os.path.join(pdir, "micro.cu")) as fh:
            jobs.append(("parent", fh.read(), pdir))
    if "--variants" in args:
        jobs += [("_".join(f"{k.lower()}{v}" for k, v in values.items()),
                  variant(text, values), str(_build.CSRC))
                 for values in VARIANTS]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(jobs)) as pool:
        built = list(pool.map(lambda j: build(*j), jobs))
    print(f"[build] {len(built)} builds in {time.perf_counter() - t0:.1f} s")
    for tag, _, ptxas, pointers in built:
        print(f"[ptxas] {tag}: {ptxas} ({pointers} pointers)")
    fns = {tag: (load(lib, pointers), pointers)
           for tag, lib, _, pointers in built}

    inputs = cases(device)
    hp, wp = ((cs.H + 7) // 8) * 8, ((cs.W + 127) // 128) * 128
    ntx = wp // 128

    i32 = lambda t: t.to(torch.int32).reshape(-1).contiguous()
    held = {}  # the kernels' inputs of each case, made once
    for case, (table, bins, params, lights, mode) in inputs.items():
        table, row_stride = raster.kernel_table(table)
        held[case] = (table, row_stride, i32(bins["pair_tri"]),
                      i32(bins["seg_start"]), i32(bins["seg_count"]),
                      i32(bins["worklist"]), i32(bins["k"]), params, lights,
                      mode)

    def run(tag, case, acc=None):
        fn, pointers = fns[tag]
        table, row_stride, pairs, starts, counts, wl, k, params, lights, \
            mode = held[case]
        out, key = raster.cleared_outputs(mode, lights.shape[0], hp, wp,
                                          device,
                                          no_id=raster.PAIR_IDX_CLEAR)
        words, arrivals = common.merge_scratch(device, hp, wp)
        ptrs = [table.data_ptr(), pairs.data_ptr(), starts.data_ptr(),
                counts.data_ptr(), wl.data_ptr(), k.data_ptr(),
                params.data_ptr(), lights.data_ptr(), out.data_ptr(),
                key.data_ptr(), words.data_ptr(), arrivals.data_ptr()]
        if pointers == 14:  # the winners' plane and the accumulator
            ptrs.append(micro.ids_scratch(device, hp, wp).data_ptr())
        if pointers >= 13:
            ptrs.append(None if acc is None else acc.data_ptr())
        _build.check(fn(*ptrs, raster.MODES[mode], row_stride, ntx * hp // 8,
                        lights.shape[0], ntx, wp, pairs.shape[0],
                        torch.cuda.current_stream(device).cuda_stream),
                     f"raster_shade_micro {tag}")
        return out, key

    bits = lambda t: t.view(torch.int32) if t.dtype != torch.int32 else t
    for case, (table, bins, params, lights, mode) in inputs.items():
        acc = torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                          device=device)
        ref_out, ref_key = run("tree", case, acc)
        _, twin_key = micro.raster_shade_micro_plain(
            table, bins["pair_tri"], bins["seg_start"], bins["seg_count"],
            params, lights, height_padded=hp, width_padded=wp, mode=mode)
        samples = int(micro.samples_tested_plain(
            table, bins["pair_tri"], bins["seg_start"], bins["seg_count"],
            params, width_padded=wp))
        if not torch.equal(ref_key.view(torch.int32), twin_key):
            raise SystemExit(f"{case}: the kernel's keys differ from the "
                             "twin's")
        if int(acc[4]) != samples:
            raise SystemExit(f"{case}: the kernel counts {int(acc[4])} "
                             f"samples, the twin {samples}")
        ref_out = raster.defined_planes(ref_out, ref_key)
        for tag in fns:
            out, key = run(tag, case)
            out = raster.defined_planes(out, key)
            if not (torch.equal(bits(key), bits(ref_key))
                    and torch.equal(bits(out), bits(ref_out))):
                raise SystemExit(f"{case}: {tag}'s outputs differ from the "
                                 "tree's")
        pairs = int(bins["seg_count"].sum())
        print(f"[check] {case}: every build equals the tree's kernel bit for "
              f"bit, keys as the twin's; {pairs} pairs, samples tested "
              f"{samples} ({samples / max(pairs, 1):.2f} a pair) as the "
              f"twin's")

    results = {}
    tags = list(fns)
    for r in range(rounds):
        for order in (tags, tags[::-1]):
            for tag in order:
                for case in inputs:
                    ms = cs.kernel_device_ms(lambda: run(tag, case), 20,
                                             "micro_kernel")
                    results.setdefault(case, {}).setdefault(tag, []).append(
                        ms)
    for case, per in results.items():
        ref = "parent" if "parent" in per else "tree"
        base = min(m for m in per[ref] if m is not None)
        for tag, ms in per.items():
            got = [m for m in ms if m is not None]
            print(f"[time] {case:32s} {tag:28s} "
                  f"{' '.join(f'{m:.6f}' for m in got)} ms (min "
                  f"{min(got):.6f}, {min(got) / base:.3f}x {ref}; "
                  f"{len(ms) - len(got)} unread)")
    print(f"[time] card: {card}")
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "compare_micro.json"),
              "w") as fh:
        json.dump({"card": card, "ptxas": {t: p for t, _, p, _ in built},
                   "ms": results}, fh, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
