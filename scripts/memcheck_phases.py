#!/usr/bin/env python3
"""Memory checks of the port's newest kernels on one card, small enough
to run under NVIDIA's compute-sanitizer where the card's machine supports
it, and a guard-band check of every buffer the kernels write where it
does not:

    python3 scripts/memcheck_phases.py [guard] [anisotropic]
    compute-sanitizer --tool memcheck --error-exitcode 9 \\
        python3 scripts/memcheck_phases.py
    compute-sanitizer --tool racecheck --error-exitcode 9 \\
        python3 scripts/memcheck_phases.py guard

Parts, each named on the command line (both when none is):

- ``guard``: the bin sort (csrc/sort.cu), the expansion's row-major mode
  (csrc/expand.cu) and the vertex stage (csrc/texture.cu) called through
  their C entries with every input, output and scratch buffer cut from
  the middle of a larger one filled with a canary word: after each call
  the canaries must be untouched (no write out of bounds) and the
  outputs equal to the twins' (as ``chip_smoke.py`` checks them), on the
  bin sort cases of tests/test_torch_bin_sort.py (the stress segment of
  ``chip_smoke.SORT_STRESS`` pairs included), the one-bin and
  distinct-bin lists of ``chip_smoke.extreme_sort_lists``, San Miguel's
  stand-in's
  cells and tiles, and Suzanne's vertices, plain and under the wave;
- ``anisotropic``: ``chip_smoke.py`` phase 12's +anisotropic row
  (structured_scene.obj through ``Renderer`` on the micro path): one
  checked frame (the eager warm-up and the CUDA graph's capture), then
  the profiled replays of ``compare_eager_graph`` (``profile_batch`` of
  the graph and ``host_calls_per_frame``), where a SIGSEGV in
  ``CUDAGraph.replay`` was seen (ROADMAP queue 3).

A failed check exits 1; the sanitizer's own report and exit code name a
memory fault or a race.
"""

import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARTS = ("guard", "anisotropic")
# Canary words either side of each guarded buffer: 16 KiB, so that a
# buffer's base keeps the 16-byte alignment the kernels' vector stores
# need.
GUARD = 4096
CANARY = -0x21524111  # 0xDEADBEEF


class Guarded:
    """Buffers cut from canary-filled allocations: ``new(n)`` gives an
    int32 view of n words (``like(t)`` a copy of t) between two bands of
    GUARD canaries; ``check(tag)`` fails if any band changed."""

    def __init__(self, device):
        self.device = device
        self.bufs = []

    def new(self, n, dtype=None):
        import torch

        buf = torch.full((n + 2 * GUARD,), CANARY, dtype=torch.int32,
                         device=self.device)
        self.bufs.append((buf, n))
        view = buf[GUARD:GUARD + n]
        return view if dtype is None else view.view(dtype)

    def like(self, t):
        import torch

        out = self.new(t.numel() * t.element_size() // 4)
        out.view(torch.uint8).copy_(t.contiguous().view(-1).view(torch.uint8))
        return out.view(t.dtype).view(t.shape)

    def check(self, cs, tag):
        import torch

        torch.cuda.synchronize()
        for i, (buf, n) in enumerate(self.bufs):
            bands = torch.cat([buf[:GUARD], buf[GUARD + n:]])
            cs.require(bool((bands == CANARY).all()),
                       f"guard {tag}: buffer {i} ({n} words) was written "
                       f"out of bounds")
        self.bufs.clear()


def guarded_bin_sort(cs, device, keys, tris, total, num_bins, group, cap,
                     meta, ntx, tag):
    """``binning._bin_sort_cuda``'s call with every buffer guarded (its
    scratch included); returns the outputs as ``bin_sort`` gives them."""
    import torch

    from compute_renderer_torch import _build
    from compute_renderer_torch.backends import binning

    g = Guarded(device)
    pair_cap = keys.shape[0]
    keys, tris = g.like(keys), g.like(tris)
    total = g.like(total.reshape(1))
    rows = [None] * 4
    T = 0
    if meta is not None:
        T = meta.shape[1]
        rows = [g.like(meta[i].contiguous()) for i in (3, 2, 0, 1)]
    num_tiles = num_bins // group
    scratch = g.new(binning.sort_scratch_ints(pair_cap, num_bins,
                                              meta is not None))
    pair_tri = g.new(pair_cap)
    seg_start, seg_count = g.new(num_bins), g.new(num_bins)
    tile_count = g.new(num_tiles) if group == 16 else None
    win_start = g.new(num_tiles) if group == 16 else None
    worklist, scal = g.new(num_tiles), g.new(4)
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    fn = _build.entry("sort", "bin_sort", pointers=16, ints=6)
    _build.check(fn(
        keys.data_ptr(), tris.data_ptr(), total.data_ptr(),
        *(ptr(r) for r in rows), scratch.data_ptr(), pair_tri.data_ptr(),
        seg_start.data_ptr(), seg_count.data_ptr(), ptr(tile_count),
        ptr(win_start), worklist.data_ptr(), scal.data_ptr(), None, T,
        pair_cap, num_bins, group, cap, ntx,
        torch.cuda.current_stream(device).cuda_stream), "bin_sort")
    out = {"pair_tri": pair_tri.clone(), "seg_start": seg_start.clone(),
           "seg_count": seg_count.clone(), "total_pairs": scal[2].clone(),
           "pair_needed": scal[0].clone(), "tile_needed": scal[1].clone(),
           "worklist": worklist.clone(), "k": scal[3].clone(),
           "overflow": scal[0:2].clone()}
    if group == 16:
        out["tile_count"], out["win_start"] = (tile_count.clone(),
                                               win_start.clone())
    g.check(cs, f"bin_sort {tag}")
    return out


def part_guard(cs, device):
    import torch

    from compute_renderer_torch import _build
    from compute_renderer_torch.backends import (
        binning, common, expand, front,
    )
    from tests.torch_bin_cases import (
        LONG, MICRO_SORT_CASES, SORT_CASES, sort_case, sort_pairs,
    )

    def on(a):
        return torch.from_numpy(a).to(device)

    def sort_and_check(tag, keys, tris, total, num_bins, group, cap, meta,
                       ntx):
        exact = None
        if meta is not None:
            exact = binning.exact_tile_counts(binning.setup_from_meta(meta),
                                              ntx, num_bins // ntx)
        want = binning.bin_sort_plain(keys, tris, total, num_bins,
                                      group=group, cap=cap, exact=exact)
        got = guarded_bin_sort(cs, device, keys, tris, total, num_bins,
                               group, cap, meta, ntx, tag)
        cs.compare_bins(f"guard {tag}", got, want,
                        min(int(total), keys.shape[0]))
        print(f"[memcheck] guard bin_sort {tag}: canaries intact, outputs "
              "equal to the twin's")

    for layout, names in (("micro", MICRO_SORT_CASES),
                          ("flat", SORT_CASES)):
        for name in names:
            for long in ((LONG, cs.SORT_STRESS) if name == "long"
                         else (LONG,)):
                meta, ntx, nty, pair_cap, cap = sort_case(layout, name,
                                                          long=long)
                keys, tris, total = sort_pairs(meta, ntx, ntx * nty,
                                               pair_cap)
                micro = layout == "micro"
                sort_and_check(
                    f"{layout} {name} {long}", on(keys), on(tris),
                    torch.full((), total, dtype=torch.int32, device=device),
                    ntx * nty, 16 if micro else 1,
                    binning.CAP_NONE if micro else cap,
                    None if micro else on(meta), ntx)

    for tag, keys, tris, total, num_bins, group in cs.extreme_sort_lists(
            device):
        sort_and_check(tag, keys, tris, total, num_bins, group,
                       binning.CAP_NONE, None, 0)

    scene = cs.bench_scene(cs.SAN_MIGUEL, eye=cs.SAN_MIGUEL_EYE)
    x = cs.frame_inputs(scene, device)
    args = (x["pos_soa"], x["nrm_soa"], x["vp"], x["eff"])
    for (th, tw), micro in (((8, 8), True), ((16, 256), False)):
        _, meta = front._front_end_cuda(*args, width=cs.W, height=cs.H,
                                        tile_h=th, tile_w=tw)
        if micro:
            ntx, nty = (cs.W + 127) // 128 * 16, (cs.H + 7) // 8
        else:
            ntx, nty = cs.W // tw, cs.H // th
        num_bins = ntx * nty
        pair_cap = int(meta[3].sum()) + 1024
        # The expansion, guarded: its row-major mode gives both layouts'
        # ids (the micro cells are the row-major ids of the cell grid).
        g = Guarded(device)
        T = meta.shape[1]
        rows = [g.like(meta[i].contiguous()) for i in (3, 2, 0, 1)]
        blocks = -(-T // expand.TRIS)
        sums, total = g.new(blocks), g.new(1)
        keys, tris = g.new(pair_cap), g.new(pair_cap)
        fn = _build.entry("expand", "expand_rows_i32", pointers=8, ints=5)
        _build.check(fn(*(r.data_ptr() for r in rows), sums.data_ptr(),
                        total.data_ptr(), keys.data_ptr(), tris.data_ptr(),
                        T, blocks, pair_cap, ntx, num_bins,
                        torch.cuda.current_stream(device).cuda_stream),
                     "expand_rows_i32")
        keys, tris, total = keys.clone(), tris.clone(), total[0].clone()
        g.check(cs, f"expand san_miguel {th}x{tw}")
        tag = f"san_miguel {th}x{tw}"
        if micro:
            sort_and_check(tag, keys, tris, total, num_bins, 16,
                           binning.CAP_NONE, None, ntx)
        else:
            need = binning.exact_tile_counts(binning.setup_from_meta(meta),
                                             ntx, nty)
            sort_and_check(tag, keys, tris, total, num_bins, 1,
                           int(need.max()), meta, ntx)

    from compute_renderer_torch.core.effects import Effect, WaveDirection

    for effect in (None, Effect.wave(0.4, 3.0, 2.0, WaveDirection.VERTICAL)):
        x = cs.frame_inputs(cs.bench_scene(effect=effect), device)
        g = Guarded(device)
        N = x["positions"].shape[0]
        pos = g.like(x["positions"].float())
        vp, eff = g.like(x["vp"].float()), g.like(x["eff"].float())
        world = g.new(3 * N, torch.float32)
        screen = g.new(4 * N, torch.float32)
        fn = _build.entry("texture", "vertex_stage", pointers=5, ints=3)
        _build.check(fn(pos.data_ptr(), vp.data_ptr(), eff.data_ptr(),
                        world.data_ptr(), screen.data_ptr(), N, cs.W, cs.H,
                        torch.cuda.current_stream(device).cuda_stream),
                     "vertex_stage")
        wk, sk = world.clone().view(N, 3), screen.clone().view(N, 4)
        g.check(cs, "vertex_stage")
        wp, sp = common.vertex_stage(x["positions"], x["vp"], x["eff"],
                                     cs.W, cs.H)
        cs.require(torch.equal(wk.view(torch.int32), wp.view(torch.int32))
                   and torch.equal(sk.view(torch.int32),
                                   sp.view(torch.int32)),
                   "guard vertex_stage: differs from common.vertex_stage")
        print(f"[memcheck] guard vertex_stage "
              f"{'wave' if effect else 'plain'}: N={N}, canaries intact, "
              "bitwise")


def part_anisotropic(cs, device):
    from compute_renderer_torch.bench import profiling

    scenes = cs.load_ext_scenes()
    scene = cs.scene_copy(scenes["structured+textures"],
                          texture_filter="anisotropic")
    renderer, scene, batch, imgs, launches = cs.render_row(device, scene, 1)
    cs.require(launches["raster_shade_micro.texf_mip"] >= 1,
               "the +anisotropic row did not launch the micro raster")

    def make_batch(n):
        return [scene.update(cs.DT) for _ in range(n)]

    calls = profiling.host_calls_per_frame(renderer, make_batch)
    p = profiling.profile_batch(renderer, make_batch(16), cs.MICRO_LAYERS)
    cs.require(not renderer.flush_overflow(), "overflow")
    print(f"[memcheck] +anisotropic: captured, {calls} host calls a frame "
          f"through the graph, profiled replays busy {p['busy_ms']:.6f} "
          f"ms/frame in {p['kernels']:.1f} kernels")


def main() -> int:
    sys.path.insert(0, ROOT)
    os.chdir(ROOT)
    import torch

    if not torch.cuda.is_available():
        print("memcheck_phases: needs a CUDA card", file=sys.stderr)
        return 3
    import chip_smoke as cs
    from compute_renderer_torch import _build

    parts = sys.argv[1:] or list(PARTS)
    unknown = set(parts) - set(PARTS)
    if unknown:
        print(f"memcheck_phases: unknown parts {sorted(unknown)} (parts "
              f"{PARTS})", file=sys.stderr)
        return 2
    _build.build_all(["front", "raster", "expand", "micro", "bins",
                      "texture", "sort"])
    device = torch.device("cuda:0")
    for part in parts:
        t0 = time.perf_counter()
        try:
            globals()[f"part_{part}"](cs, device)
        except cs.SmokeFailure as e:
            print(f"memcheck_phases: {part}: FAILED: {e}", file=sys.stderr)
            return 1
        torch.cuda.synchronize()
        print(f"[memcheck] {part}: {time.perf_counter() - t0:.1f} s",
              flush=True)
    print("[memcheck] done")
    return 0


if __name__ == "__main__":
    sys.exit(main())
