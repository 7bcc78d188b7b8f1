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
  then the kernels of the benchmark's structured_trilinear cell on its
  first frame (the 1,023,442-triangle scene with its 4096-texel ground,
  written and loaded through ``frame_bench``'s harness):
  ``mip_rows_kernel<2>``, ``front_kernel<4>``, ``micro_kernel`` with
  ``micro_kernel_shade<4>`` and ``texture_tail_mip_kernel<2>``, each
  called twice with different canary words around every buffer it
  reads or writes: the canaries must be untouched, the two calls'
  outputs bitwise equal (a read out of bounds would differ) and equal to
  the wrappers' unguarded launch, and the tail's textured-pixel count
  equal to ``texture.textured_pixels_plain``'s. The micro raster's
  G-buffer is compared where its key is set (its planes are undefined
  elsewhere) and its key everywhere; its key-clear pixels keep the
  canary, so the tail reads a G-buffer poisoned there with 0xDEADBEEF,
  then with a quiet NaN, and must give the image and count of the same
  G-buffer zeroed there; then the dense layout's scan
  (``bin_scan_kernel``, both launches of ``bin_tiles_dense``) with the
  accumulator at Suzanne's frame, and the structured_tex_aniso cell's
  tile path on its first frame (the 36,322-triangle scene with its
  4096-texel ground): ``mip_rows_kernel<3>``, and at each of the
  tuner's tile shapes the flat layout's bin sort with the accumulator
  and its span list, and ``raster_kernel<4>`` and ``raster_kernel<0>``
  on its pair list with that span list (the span merge's words and
  counters guarded too, and left clear by every launch), then
  ``texture_tail_mip_kernel<3>`` on the poisoned G-buffer, each twice
  between canaries as above; both scans' folds (the longest-list and
  span words included) and the span list equal to the twins';
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
# The texture path's two canaries: 0xDEADBEEF, and a quiet NaN, which a
# float read out of bounds would carry into its output.
CANARIES = (CANARY, 0x7FC00001)


class Guarded:
    """Buffers cut from canary-filled allocations: ``new(n)`` gives an
    int32 view of n words (``like(t)`` a copy of t) between two bands of
    GUARD ``canary`` words; ``check(tag)`` fails if any band changed."""

    def __init__(self, device, canary=CANARY):
        self.device = device
        self.canary = canary
        self.bufs = []

    def new(self, n, dtype=None):
        import torch

        buf = torch.full((n + 2 * GUARD,), self.canary, dtype=torch.int32,
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
            cs.require(bool((bands == self.canary).all()),
                       f"guard {tag}: buffer {i} ({n} words) was written "
                       f"out of bounds")
        self.bufs.clear()


def guarded_bin_sort(cs, device, keys, tris, total, num_bins, group, cap,
                     meta, ntx, tag):
    """``binning._bin_sort_cuda``'s call with every buffer guarded (its
    scratch included); returns the outputs as ``bin_sort`` gives them."""
    g = Guarded(device)
    out, _ = bin_sort_call(g, device, keys, tris, total, num_bins, group,
                           cap, meta, ntx)
    g.check(cs, f"bin_sort {tag}")
    return out


def bin_sort_call(g, device, keys, tris, total, num_bins, group, cap, meta,
                  ntx, acc=None, spans=False):
    """``binning._bin_sort_cuda``'s call with every buffer (its scratch
    included, and a copy of the accumulator ``acc`` where given) cut from
    the Guarded ``g``; returns the outputs as ``bin_sort`` gives them,
    cloned (with ``spans``, the span list too), and the
    accumulator's copy after the call (or None)."""
    import torch

    from compute_renderer_torch import _build
    from compute_renderer_torch.backends import binning

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
                                              meta is not None, spans))
    pair_tri = g.new(pair_cap)
    seg_start, seg_count = g.new(num_bins), g.new(num_bins)
    tile_count = g.new(num_tiles) if group == 16 else None
    win_start = g.new(num_tiles) if group == 16 else None
    worklist, scal = g.new(num_tiles), g.new(5)
    acc = None if acc is None else g.like(acc)
    ptr = lambda a: None if a is None else a.data_ptr()  # noqa: E731
    fn = _build.entry("sort", "bin_sort", pointers=16, ints=7)
    _build.check(fn(
        keys.data_ptr(), tris.data_ptr(), total.data_ptr(),
        *(ptr(r) for r in rows), scratch.data_ptr(), pair_tri.data_ptr(),
        seg_start.data_ptr(), seg_count.data_ptr(), ptr(tile_count),
        ptr(win_start), worklist.data_ptr(), scal.data_ptr(), ptr(acc), T,
        pair_cap, num_bins, group, cap, ntx, int(spans),
        torch.cuda.current_stream(device).cuda_stream), "bin_sort")
    out = {"pair_tri": pair_tri.clone(), "seg_start": seg_start.clone(),
           "seg_count": seg_count.clone(), "total_pairs": scal[2].clone(),
           "pair_needed": scal[0].clone(), "tile_needed": scal[1].clone(),
           "most": scal[4].clone(), "worklist": worklist.clone(),
           "k": scal[3].clone(), "overflow": scal[0:2].clone()}
    if group == 16:
        out["tile_count"], out["win_start"] = (tile_count.clone(),
                                               win_start.clone())
    if spans:
        base = binning.span_offset(num_bins, meta is not None, spans)
        count = 1 + 2 * binning.span_slots(pair_cap)
        out["spans"] = scratch[base:base + count].clone()
    return out, None if acc is None else acc.clone()


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

    guard_texture_path(cs, device)
    guard_dense_scan(cs, device)
    guard_tile_texture_path(cs, device)


def texture_path_frame(device, name="structured_trilinear"):
    """The first frame on the card of the benchmark's configuration
    ``name``: its program (``frame_bench.harness.Program``: the scene
    written, loaded with its images, the mip pool uploaded) and the
    frame's tensors."""
    import torch

    from compute_renderer_torch.engine.renderer import unpack_uniforms
    from frame_bench import harness

    config = harness.load_json("configs", name)
    arrays = harness.build_scene(config)
    try:
        program = harness.Program(config, arrays, device)
    finally:
        arrays.remove_files()
    r = program.renderer
    packed, L = r.pack_uniforms(program.look(0.0, 0.0, 1.0 / 60.0))
    vpos, vp, eff, lwp, lc, li = unpack_uniforms(
        torch.from_numpy(packed).to(device), L)
    return program, {"vpos": vpos, "vp": vp, "eff": eff, "lwp": lwp,
                     "lc": lc, "li": li, "W": config["width"],
                     "H": config["height"]}


def guarded_twice(cs, device, tag, call):
    """``call(g)`` (buffers from the Guarded ``g``; returns its outputs as
    clones) under each of ``CANARIES``: every band intact, and the outputs
    of the two calls bitwise equal. Returns the first call's outputs."""
    import torch

    outs = []
    for canary in CANARIES:
        g = Guarded(device, canary)
        outs.append(call(g))
        g.check(cs, f"{tag} canary {canary & 0xFFFFFFFF:#010x}")
    for i, (a, b) in enumerate(zip(*outs)):
        cs.require(torch.equal(a.view(torch.uint8), b.view(torch.uint8)),
                   f"guard {tag}: output {i} differs between the canaries")
    return outs[0]


def require_bitwise(cs, tag, got, want):
    import torch

    cs.require(got.shape == want.shape and torch.equal(
        got.contiguous().view(torch.uint8),
        want.contiguous().view(torch.uint8)),
        f"guard {tag}: differs from the unguarded launch")


def guard_texture_path(cs, device):
    """The texture path of the structured_trilinear cell, each kernel's C
    entry guarded twice (``guarded_twice``) at the cell's shapes."""
    import torch

    from compute_renderer_torch import _build
    from compute_renderer_torch.backends import (
        binning, common, front, micro, raster, texture,
    )

    program, f = texture_path_frame(device)
    r = program.renderer
    ext, W, H = r.ext, f["W"], f["H"]
    T = r.num_triangles
    levels = ext["tex_mips"].shape[1]
    stream = torch.cuda.current_stream(device).cuda_stream
    print(f"[memcheck] guard texture path: T={T}, pool "
          f"{ext['texels'].shape[0]} texels, {levels} levels, {W}x{H}")

    # mip_rows_kernel<2>: the frame's (T, 5) rows.
    def mip_rows(g):
        rows = g.new(5 * T, torch.float32)
        fn = _build.entry("texture", "mip_rows", pointers=8, ints=5)
        _build.check(fn(
            g.like(r.positions).data_ptr(), g.like(r.tri).data_ptr(),
            g.like(ext["uvs"]).data_ptr(), g.like(ext["face_tex"]).data_ptr(),
            g.like(ext["tex_mips"]).data_ptr(), g.like(f["vp"]).data_ptr(),
            g.like(f["eff"]).data_ptr(), rows.data_ptr(), T, levels, W, H,
            texture.FILTERS["trilinear"], stream), "mip_rows")
        return [rows.clone().view(T, 5)]

    (rows,) = guarded_twice(cs, device, "mip_rows", mip_rows)
    require_bitwise(cs, "mip_rows", rows, texture.mip_rows(
        r.positions, r.tri, ext["uvs"], ext["face_tex"], ext["tex_mips"],
        f["vp"], f["eff"], W, H, "trilinear"))
    textured = ext["face_tex"] >= 0
    lod = rows[:, 1][textured]
    print(f"[memcheck] guard mip_rows: canaries intact, bitwise; lod of the "
          f"{int(textured.sum())} textured triangles: "
          + ", ".join(f"[{a}, {a + 1}) {int(((lod >= a) & (lod < a + 1)).sum())}"
                      for a in range(levels)))

    # front_kernel<4>: the (T, R) table and the meta, 8x8 cells.
    mode = "texf_mip"
    width = raster.MODE_WIDTHS[mode]
    stride = raster.table_stride(width)
    scal = torch.cat([f["vp"].reshape(16), f["eff"].reshape(-1)[:6]])

    def front_end(g):
        table, meta = g.new(T * stride, torch.float32), g.new(4 * T)
        fn = _build.entry("front", "front_end", pointers=8, ints=6)
        _build.check(fn(
            g.like(r.pos_soa).data_ptr(), g.like(r.nrm_soa).data_ptr(),
            g.like(scal).data_ptr(), g.like(ext["face_kd"]).data_ptr(),
            g.like(ext["uv_soa"]).data_ptr(), g.like(rows).data_ptr(),
            table.data_ptr(), meta.data_ptr(), raster.MODES[mode], T, W, H,
            8, 8, stream), "front_end")
        return [table.clone().view(T, stride)[:, :width].contiguous(),
                meta.clone().view(4, T)]

    table, meta = guarded_twice(cs, device, "front_end texf_mip", front_end)
    want_table, want_meta = front._front_end_cuda(
        r.pos_soa, r.nrm_soa, f["vp"], f["eff"], width=W, height=H,
        tile_h=8, tile_w=8, kd_rows=ext["face_kd"], uv_soa=ext["uv_soa"],
        mip_rows=rows)
    require_bitwise(cs, "front_end texf_mip", table, want_table)
    require_bitwise(cs, "front_end texf_mip meta", meta, want_meta)
    print("[memcheck] guard front_end texf_mip: canaries intact, bitwise")

    # micro_kernel + micro_kernel_shade<4>: the G-buffer and the keys, on
    # the frame's own cell binning.
    ntx, nty = (W + 127) // 128, (H + 7) // 8
    Hp, Wp = nty * 8, ntx * 128
    pair_cap = int(want_meta[3].sum()) + 1024
    bins = binning.bin_cells_sort_meta(want_meta[3], want_meta[2],
                                       want_meta[0], want_meta[1], ntx, nty,
                                       pair_cap)
    cs.require(not bool(bins["overflow"].any()), "guard micro: overflow")
    params, lights = raster.shading_inputs(f["eff"], f["vpos"], f["lwp"],
                                           f["lc"], f["li"])
    L = lights.shape[0]
    ktable, row_stride = raster.kernel_table(want_table)
    # The rows as the kernel reads them: their pad column included.
    ktable = ktable.as_strided((T, row_stride), (row_stride, 1))
    out0, key0 = raster.cleared_outputs(mode, L, Hp, Wp, device,
                                        no_id=raster.PAIR_IDX_CLEAR)
    words0, arrivals0 = common.merge_scratch(device, Hp, Wp)
    n_pairs = bins["pair_tri"].shape[0]

    poisoned = {}  # canary -> the G-buffer, its key-clear pixels unwritten

    def micro_raster(g):
        out = g.new(out0.numel(), torch.float32).view(out0.shape)
        key = g.like(key0)
        acc = g.like(torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                                 device=device))
        fn = _build.entry("micro", "raster_shade_micro", pointers=14,
                          ints=7)
        _build.check(fn(
            g.like(ktable).data_ptr(), g.like(bins["pair_tri"]).data_ptr(),
            g.like(bins["seg_start"]).data_ptr(),
            g.like(bins["seg_count"]).data_ptr(),
            g.like(bins["worklist"]).data_ptr(),
            g.like(bins["k"].reshape(1)).data_ptr(), g.like(params).data_ptr(),
            g.like(lights).data_ptr(), out.data_ptr(), key.data_ptr(),
            g.like(words0).data_ptr(), g.like(arrivals0).data_ptr(),
            g.new(Hp * Wp).data_ptr(), acc.data_ptr(), raster.MODES[mode],
            row_stride, ntx * nty, L, ntx, Wp, n_pairs, stream),
            "raster_shade_micro")
        clear = out.view(torch.int32)[:, key == -1]
        cs.require(clear.numel() > 0 and bool((clear == g.canary).all()),
                   "guard micro: the key-clear pixels do not all hold the "
                   "canary, so the tail would not read a poisoned G-buffer")
        poisoned[g.canary] = out.clone()
        return [raster.defined_planes(out, key), key.clone(), acc.clone()]

    gbuf, key, acc = guarded_twice(cs, device, "raster_shade_micro texf_mip",
                                   micro_raster)
    want_acc = torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                           device=device)
    want_gbuf, want_key = micro.raster_shade_micro(
        want_table, bins["pair_tri"], bins["seg_start"], bins["seg_count"],
        bins["tile_count"], f["eff"], f["vpos"], f["lwp"], f["lc"], f["li"],
        height_padded=Hp, width_padded=Wp, mode=mode,
        worklist=(bins["worklist"], bins["k"]), acc=want_acc)
    require_bitwise(cs, "raster_shade_micro texf_mip", gbuf,
                    raster.defined_planes(want_gbuf, want_key))
    require_bitwise(cs, "raster_shade_micro texf_mip key", key,
                    want_key.view(torch.int32))
    require_bitwise(cs, "raster_shade_micro texf_mip samples", acc,
                    want_acc)
    print(f"[memcheck] guard raster_shade_micro texf_mip: {n_pairs} pairs, "
          f"{int(acc[4])} samples, canaries intact, bitwise")

    # texture_tail_mip_kernel<2>: RGBA and the textured count, the
    # G-buffer and the key read in place through their row strides; each
    # call's G-buffer holds its own canary where the key is clear, and the
    # wrapper's reference reads the G-buffer zeroed there.
    g_win = raster.defined_planes(want_gbuf, want_key)[..., :H, :W]
    k_win = want_key[:H, :W]
    texels, mips = ext["texels"], ext["tex_mips"]
    lc, li = f["lc"].float(), f["li"].float()

    def tail(g):
        gb = g.like(poisoned[g.canary])
        kb = g.like(want_key.view(torch.int32))
        out = g.new(H * W)
        acc = g.like(torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                                 device=device))
        fn = _build.entry("texture", "texture_tail_mip", pointers=8, ints=8)
        _build.check(fn(
            gb.data_ptr(), kb.data_ptr(), g.like(texels).data_ptr(),
            g.like(mips).data_ptr(), g.like(lc).data_ptr(),
            g.like(li).data_ptr(), out.data_ptr(), acc.data_ptr(), H, W,
            Hp * Wp, Wp, Wp, L, levels, texture.FILTERS["trilinear"],
            stream), "texture_tail_mip")
        return [out.clone().view(H, W), acc.clone()]

    rgba, acc = guarded_twice(cs, device, "texture_tail_mip", tail)
    want_acc = torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                           device=device)
    want_rgba = texture.texture_tail_mip(g_win, k_win, texels, mips, lc, li,
                                         tex_filter="trilinear",
                                         acc=want_acc)
    require_bitwise(cs, "texture_tail_mip", rgba,
                    want_rgba.view(torch.int32).view(H, W))
    plain = int(texture.textured_pixels_plain(g_win, k_win))
    cs.require(int(acc[5]) == int(want_acc[5]) == plain
               and not bool(acc[:5].any()),
               f"guard texture_tail_mip: counted {acc.tolist()}, the "
               f"wrapper {want_acc.tolist()}, the plain count {plain}")
    print(f"[memcheck] guard texture_tail_mip trilinear: {plain} textured "
          f"pixels of {int((k_win.view(torch.int32) != -1).sum())} covered, "
          "the kernel's count equal to the plain count, canaries intact, "
          "bitwise, the G-buffer poisoned where the key is clear")
    has = (k_win.view(torch.int32) != -1) & (g_win[5] >= 0)
    lod = g_win[6][has]
    print("[memcheck] lod of the textured pixels: "
          + ", ".join(f"[{a}, {a + 1}) {int(((lod >= a) & (lod < a + 1)).sum())}"
                      for a in range(levels)))
    program.close()


def longest_acc(device):
    """An accumulator holding a longest list from an earlier frame, 1, so
    that the fold's max is seen to keep the larger word."""
    import torch

    from compute_renderer_torch.backends import binning

    acc = torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                      device=device)
    acc[7] = 1
    return acc


def require_fold(cs, tag, acc, start, bins):
    """``acc`` is ``start`` with ``bins``' frame folded in by the twins'
    fold (``binning.fold_counts``): the needs, pairs, occupied tiles and
    the longest list."""
    from compute_renderer_torch.backends import binning

    want = start.clone()
    binning.fold_counts(want, bins)
    cs.require(acc.tolist() == want.tolist(),
               f"guard {tag}: the kernel folds {acc.tolist()}, the twin "
               f"{want.tolist()}")


def guard_dense_scan(cs, device):
    """``bin_scan_kernel`` (csrc/bins.cu, the dense layout of
    suzanne.batch) with its accumulator: both launches of
    ``bin_tiles_dense`` guarded twice at Suzanne's frame, at each of the
    tuner's tile shapes; the outputs, scal and the fold (the longest-list
    word included) equal to the twin's."""
    import torch

    from compute_renderer_torch import _build
    from compute_renderer_torch.backends import binning, cuda, front

    x = cs.frame_inputs(cs.bench_scene(), device)
    stream = torch.cuda.current_stream(device).cuda_stream
    for th, tw in cuda.TILE_CANDIDATES:
        _, meta = front._front_end_cuda(x["pos_soa"], x["nrm_soa"], x["vp"],
                                        x["eff"], width=cs.W, height=cs.H,
                                        tile_h=th, tile_w=tw)
        meta = meta.contiguous()
        ntx, nty = -(-cs.W // tw), -(-cs.H // th)
        num_tiles, T = ntx * nty, meta.shape[1]
        tile_cap = binning.default_tile_cap(T, cs.W, cs.H, th, tw)
        cs.require(binning.dense_layout(ntx, nty, tile_cap, T),
                   f"guard dense scan {th}x{tw}: not the dense layout")
        C = (tile_cap + 127) // 128 * 128
        start = longest_acc(device)

        def dense(g):
            counts, rows = g.new(num_tiles), g.new(num_tiles * C)
            seg = [g.new(num_tiles) for _ in range(3)]
            scal, acc = g.new(5), g.like(start)
            fn = _build.entry("bins", "bin_tiles_dense", pointers=8, ints=5)
            _build.check(fn(
                g.like(meta).data_ptr(), counts.data_ptr(), rows.data_ptr(),
                *(s.data_ptr() for s in seg), scal.data_ptr(),
                acc.data_ptr(), T, T, ntx, num_tiles, C, stream),
                "bin_tiles_dense")
            return [rows.clone().view(num_tiles, C),
                    torch.stack(seg), scal.clone(), acc.clone()]

        tag = f"bin_tiles_dense suzanne {th}x{tw}"
        rows, seg, scal, acc = guarded_twice(cs, device, tag, dense)
        want = binning.bin_tiles_meta_plain(meta, ntx, nty, 2 * T + 1024,
                                            tile_cap)
        require_bitwise(cs, tag, rows, want["bin_rows"])
        require_bitwise(cs, f"{tag} segments", seg, torch.stack(
            [want["seg_start"], want["seg_count"], want["worklist"]]))
        require_bitwise(cs, f"{tag} scal", scal, torch.stack(
            [want[k] for k in ("pair_needed", "tile_needed", "total_pairs",
                               "k", "most")]))
        require_fold(cs, tag, acc, start, want)
        print(f"[memcheck] guard {tag}: {int(want['total_pairs'])} pairs, "
              f"longest list {int(want['most'])}, the fold equal to the "
              "twin's, canaries intact, bitwise")


def guard_tile_texture_path(cs, device):
    """The tile path of the structured_tex_aniso cell on its first frame,
    each kernel's C entry guarded twice (``guarded_twice``):
    ``mip_rows_kernel<3>``; at each of the tuner's tile shapes the flat
    layout's bin sort with the accumulator (``bin_sort_scan_kernel``'s
    fold, the longest-list and span words included) and its span list,
    and ``raster_kernel<4>`` and ``<0>`` on the flat pair list with the
    span list, the merge scratch left clear; then
    ``texture_tail_mip_kernel<3>`` on the G-buffer, poisoned where the
    key is clear."""
    import torch

    from compute_renderer_torch import _build
    from compute_renderer_torch.backends import (
        binning, cuda, expand, front, raster, texture,
    )

    program, f = texture_path_frame(device, "structured_tex_aniso")
    r = program.renderer
    ext, W, H = r.ext, f["W"], f["H"]
    T = r.num_triangles
    levels = ext["tex_mips"].shape[1]
    L = f["lc"].shape[0]
    stream = torch.cuda.current_stream(device).cuda_stream
    aniso = texture.FILTERS["anisotropic"]
    print(f"[memcheck] guard tile texture path: T={T}, pool "
          f"{ext['texels'].shape[0]} texels, {levels} levels, {W}x{H}")

    def mip_rows(g):
        rows = g.new(5 * T, torch.float32)
        fn = _build.entry("texture", "mip_rows", pointers=8, ints=5)
        _build.check(fn(
            g.like(r.positions).data_ptr(), g.like(r.tri).data_ptr(),
            g.like(ext["uvs"]).data_ptr(), g.like(ext["face_tex"]).data_ptr(),
            g.like(ext["tex_mips"]).data_ptr(), g.like(f["vp"]).data_ptr(),
            g.like(f["eff"]).data_ptr(), rows.data_ptr(), T, levels, W, H,
            aniso, stream), "mip_rows")
        return [rows.clone().view(T, 5)]

    (rows,) = guarded_twice(cs, device, "mip_rows anisotropic", mip_rows)
    require_bitwise(cs, "mip_rows anisotropic", rows, texture.mip_rows(
        r.positions, r.tri, ext["uvs"], ext["face_tex"], ext["tex_mips"],
        f["vp"], f["eff"], W, H, "anisotropic"))
    print("[memcheck] guard mip_rows anisotropic: canaries intact, bitwise")

    mode = "texf_mip"
    params, lights = raster.shading_inputs(f["eff"], f["vpos"], f["lwp"],
                                           f["lc"], f["li"])
    poisoned = {}  # canary -> the 16x256 G-buffer, key-clear unwritten
    for th, tw in cuda.TILE_CANDIDATES:
        shape = f"{th}x{tw}"
        table, meta = front._front_end_cuda(
            r.pos_soa, r.nrm_soa, f["vp"], f["eff"], width=W, height=H,
            tile_h=th, tile_w=tw, kd_rows=ext["face_kd"],
            uv_soa=ext["uv_soa"], mip_rows=rows)
        ntx, nty = -(-W // tw), -(-H // th)
        num_tiles = ntx * nty
        Hp, Wp = nty * th, ntx * tw
        exact = binning.exact_tile_counts(binning.setup_from_meta(meta), ntx,
                                          nty)
        cap = int(exact.max())
        cs.require(not binning.dense_layout(ntx, nty, cap, T),
                   f"guard tile texture path {shape}: not the flat layout")
        pair_cap = int(meta[3].sum()) + 1024
        keys, tris, total = expand._expand_cuda(
            meta[3], meta[2], meta[0], meta[1], pair_cap=pair_cap, ntx_t=0,
            num_cells=num_tiles, row_width=ntx)
        start = longest_acc(device)
        n = int(total)
        arrays = ("seg_start", "seg_count", "worklist")
        scalars = ("pair_needed", "tile_needed", "total_pairs", "k", "most")

        def flat_sort(g):
            out, acc = bin_sort_call(g, device, keys, tris, total, num_tiles,
                                     1, cap, meta, ntx, acc=start,
                                     spans=True)
            return ([out["pair_tri"][:n]] + [out[k] for k in arrays]
                    + [torch.stack([out[k] for k in scalars]), acc,
                       out["spans"]])

        tag = f"bin_sort flat structured_tex_aniso {shape}"
        got = guarded_twice(cs, device, tag, flat_sort)
        want = binning.bin_sort_plain(keys, tris, total, num_tiles, cap=cap,
                                      exact=exact, spans=True)
        require_bitwise(cs, f"{tag} pair_tri", got[0], want["pair_tri"][:n])
        for k, a in zip(arrays, got[1:4]):
            require_bitwise(cs, f"{tag} {k}", a, want[k])
        require_bitwise(cs, f"{tag} scal", got[4],
                        torch.stack([want[k] for k in scalars]))
        require_fold(cs, tag, got[5], start, want)
        require_bitwise(cs, f"{tag} spans", got[6], want["spans"])
        cs.require(int(want["most"]) == cap,
                   f"guard {tag}: longest list {int(want['most'])}, the "
                   f"rects' count {cap}")
        print(f"[memcheck] guard {tag}: {n} pairs, longest list {cap}, "
              f"{int(want['spans'][0])} spans past the tiles' "
              "first, the fold and the span list equal to the twin's, "
              "canaries intact, bitwise")

        bins = binning.bin_sort(keys, tris, total, num_tiles, cap=cap,
                                meta=meta, ntx=ntx, spans=True)
        ktable, row_stride = raster.kernel_table(table)
        ktable = ktable.as_strided((T, row_stride), (row_stride, 1))
        for rmode in (mode, "base"):  # base reads the table's first 32
            out0, key0 = raster.cleared_outputs(rmode, L, Hp, Wp, device)

            def tile_raster(g):
                out = (g.new(out0.numel(), torch.float32).view(out0.shape)
                       if out0.dim() == 3 else g.like(out0))
                key = g.like(key0)
                # The span merge's words (all ones) and counters (zero),
                # as common.merge_scratch makes them.
                merge = g.new(2 * Hp * Wp).fill_(-1)
                arrivals = g.new(Hp * Wp).zero_()
                fn = _build.entry("raster", "raster_shade_tiles",
                                  pointers=13, ints=11)
                _build.check(fn(
                    g.like(ktable).data_ptr(),
                    g.like(bins["pair_tri"]).data_ptr(),
                    g.like(bins["seg_start"]).data_ptr(),
                    g.like(bins["seg_count"]).data_ptr(),
                    g.like(bins["worklist"]).data_ptr(),
                    g.like(bins["k"].reshape(1)).data_ptr(),
                    g.like(params).data_ptr(), g.like(lights).data_ptr(),
                    out.data_ptr(), key.data_ptr(),
                    g.like(bins["spans"]).data_ptr(), merge.data_ptr(),
                    arrivals.data_ptr(), raster.MODES[rmode], row_stride,
                    num_tiles, L, ntx, th, tw, Wp, 0, 0,
                    bins["spans"].shape[0] // 2, stream),
                    "raster_shade_tiles")
                torch.cuda.synchronize()
                cs.require(bool((merge == -1).all())
                           and not bool(arrivals.any()),
                           f"guard raster {rmode} {shape}: the span merge's "
                           "words and counters are not left clear")
                if out0.dim() == 3:
                    clear = out.view(torch.int32)[:, key == -1]
                    cs.require(clear.numel() > 0
                               and bool((clear == g.canary).all()),
                               f"guard raster {shape}: the key-clear pixels "
                               "do not all hold the canary")
                    if (th, tw) == cuda.TILE_CANDIDATES[0]:
                        poisoned[g.canary] = out.clone()
                return [raster.defined_planes(out, key), key.clone()]

            tag = f"raster_shade_tiles {rmode} flat {shape}"
            gbuf, key = guarded_twice(cs, device, tag, tile_raster)
            want_gbuf, want_key = raster.raster_shade_tiles(
                table if rmode == mode else table[:, :32], bins["pair_tri"],
                bins["seg_start"], bins["seg_count"], f["eff"], f["vpos"],
                f["lwp"], f["lc"], f["li"], height_padded=Hp,
                width_padded=Wp, tile_h=th, tile_w=tw, layout="flat",
                mode=rmode, worklist=(bins["worklist"], bins["k"]),
                spans=bins["spans"])
            if rmode == mode:
                want_gbuf = raster.defined_planes(want_gbuf, want_key)
            require_bitwise(cs, tag, gbuf, want_gbuf.view(gbuf.dtype))
            require_bitwise(cs, f"{tag} key", key,
                            want_key.view(torch.int32))
            print(f"[memcheck] guard {tag}: {int(bins['k'])} occupied tiles"
                  f", {int(bins['spans'][0])} span blocks past "
                  "the tiles' first, the merge scratch left clear, "
                  "canaries intact, bitwise")
            if rmode == mode:
                keep = (want_gbuf, want_key)
        want_gbuf, want_key = keep
        if (th, tw) == cuda.TILE_CANDIDATES[0]:
            # The tail's input: this shape's G-buffer and key (both tile
            # shapes pad 1024x768 alike).
            tail_key, tail_hw = want_key, (Hp, Wp)
            g_win = raster.defined_planes(want_gbuf, want_key)[..., :H, :W]
            k_win = want_key[:H, :W]

    # texture_tail_mip_kernel<3>: RGBA and the textured count; each call's
    # G-buffer holds its own canary where the key is clear, and the
    # wrapper's reference reads the G-buffer zeroed there.
    texels, mips = ext["texels"], ext["tex_mips"]
    lc, li = f["lc"].float(), f["li"].float()
    Hp, Wp = tail_hw

    def tail(g):
        gb = g.like(poisoned[g.canary])
        kb = g.like(tail_key.view(torch.int32))
        out = g.new(H * W)
        acc = g.like(torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                                 device=device))
        fn = _build.entry("texture", "texture_tail_mip", pointers=8, ints=8)
        _build.check(fn(
            gb.data_ptr(), kb.data_ptr(), g.like(texels).data_ptr(),
            g.like(mips).data_ptr(), g.like(lc).data_ptr(),
            g.like(li).data_ptr(), out.data_ptr(), acc.data_ptr(), H, W,
            Hp * Wp, Wp, Wp, L, levels, aniso, stream), "texture_tail_mip")
        return [out.clone().view(H, W), acc.clone()]

    tag = "texture_tail_mip anisotropic"
    rgba, acc = guarded_twice(cs, device, tag, tail)
    want_acc = torch.zeros((binning.ACC_WORDS,), dtype=torch.int64,
                           device=device)
    want_rgba = texture.texture_tail_mip(g_win, k_win, texels, mips, lc, li,
                                         tex_filter="anisotropic",
                                         acc=want_acc)
    require_bitwise(cs, tag, rgba, want_rgba.view(torch.int32).view(H, W))
    plain = int(texture.textured_pixels_plain(g_win, k_win))
    cs.require(int(acc[5]) == int(want_acc[5]) == plain
               and acc.tolist() == want_acc.tolist(),
               f"guard {tag}: counted {acc.tolist()}, the wrapper "
               f"{want_acc.tolist()}, the plain count {plain}")
    print(f"[memcheck] guard {tag}: {plain} textured pixels of "
          f"{int((k_win.view(torch.int32) != -1).sum())} covered, the "
          "kernel's count equal to the plain count, canaries intact, "
          "bitwise, the G-buffer poisoned where the key is clear")
    program.close()


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
