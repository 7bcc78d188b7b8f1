#!/usr/bin/env python3
"""bench.py's frame, the structured scene's texture rows or the sort
layouts' rows, in two checkouts of the port, in turns, on one card.

    git archive <commit> | tar -x -C build/other
    python3 scripts/compare_main_path.py build/other [--texture | --bins]

Runs ``chip_smoke.phase_main_path`` (phase 5: Suzanne 1024x768 through
``Renderer``, held to the golden frames and to the eager frames, then the
eager loop against the replayed graph: slopes, busy time, kernels a
frame, idle share) and ``bench_torch.py`` in each checkout, one process a
run (the two packages share a name), in the order other, this, this,
other, so that drift on the card falls on both alike. With
``--texture`` it runs instead ``chip_smoke.compare_eager_graph`` on the
micro path's structured_scene.obj rows (+materials, +textures,
+trilinear, +anisotropic, +deferred trilinear; 1024x768, eager batches
of 16 and 64): slopes, busy time and kernels a frame, idle share and the
eager profile's layers with the texture ranges. With ``--bins`` it runs
``compare_eager_graph`` on the rows of the two sort layouts: San Miguel
and structured +deferred trilinear (micro path, the cells' sort; the
latter's per-vertex stage too) and structured_scene_tex.obj +textures
and san_miguel_small (tile path, flat layout; each tuned by a first
frame), with each checkout's own layer names. Each checkout builds its
own kernels into its own ``build/``. Prints one ``[compare]`` JSON line a
run, then a table. Needs a CUDA card; a run that fails its checks fails
the script.
"""

import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# The --texture rows: (tag, texture filter, tex_mode); None drops the
# atlas (the materials row).
TEXTURE_ROWS = (
    ("structured +materials", None, "fused"),
    ("structured +textures", "nearest", "fused"),
    ("structured +trilinear", "trilinear", "fused"),
    ("structured +anisotropic", "anisotropic", "fused"),
    ("structured +deferred trilinear", "trilinear", "deferred"),
)


def texture_rows(chip_smoke, card) -> dict:
    """The structured scene's micro rows, each a fresh renderer's eager
    loop against its graph (``chip_smoke.compare_eager_graph``)."""
    import dataclasses

    import torch

    from compute_renderer_torch import CameraConfig, Renderer, Scene
    from compute_renderer_torch import SceneConfig
    from compute_renderer_torch.io import objgen

    objgen.ensure_structured_scene()
    base = Scene.from_config(SceneConfig(
        model_path=objgen.STRUCTURED_NAME, enable_textures=True,
        camera_config=CameraConfig.first_person(chip_smoke.STRUCTURED_EYE)),
        chip_smoke.W, chip_smoke.H)
    plain = dataclasses.replace(base.mesh, face_tex=None, texels=None,
                                tex_table=None)
    out = {}
    for tag, tex_filter, tex_mode in TEXTURE_ROWS:
        scene = chip_smoke.scene_copy(base, texture_filter=tex_filter
                                      or "nearest")
        mesh = base.mesh if tex_filter else plain
        renderer = Renderer(mesh, chip_smoke.W, chip_smoke.H,
                            device=torch.device("cuda:0"), tex_mode=tex_mode,
                            **scene.renderer_options())
        chip_smoke.compare_eager_graph(
            tag, renderer, scene, card, chip_smoke.MICRO_LAYERS,
            eager_sizes=chip_smoke.SLOW_EAGER_BATCHES)
        out[tag] = chip_smoke.GRAPH_ROWS[tag]
        del renderer
        torch.cuda.empty_cache()
    return out


def bins_rows(chip_smoke, card) -> dict:
    """The sort layouts' rows, each a fresh renderer's eager loop against
    its graph (``chip_smoke.compare_eager_graph``): the micro rows with
    ``MICRO_LAYERS``, the flat tile rows with ``TILE_LAYERS`` after a
    first frame that tunes the tile shape."""
    import torch

    from compute_renderer_torch import CameraConfig, Renderer, Scene
    from compute_renderer_torch import SceneConfig
    from compute_renderer_torch.io import objgen

    objgen.ensure_structured_scene()
    objgen.ensure_textured_scene()

    def structured(name, tex_filter):
        return Scene.from_config(SceneConfig(
            model_path=name, enable_textures=True, texture_filter=tex_filter,
            camera_config=CameraConfig.first_person(
                chip_smoke.STRUCTURED_EYE)), chip_smoke.W, chip_smoke.H)

    rows = (
        ("san_miguel", lambda: chip_smoke.bench_scene(
            chip_smoke.SAN_MIGUEL, eye=chip_smoke.SAN_MIGUEL_EYE), {},
         chip_smoke.MICRO_LAYERS, (chip_smoke.BATCH_SMALL,
                                   chip_smoke.BATCH_LARGE)),
        ("structured +deferred trilinear",
         lambda: structured(objgen.STRUCTURED_NAME, "trilinear"),
         {"tex_mode": "deferred"}, chip_smoke.MICRO_LAYERS,
         chip_smoke.SLOW_EAGER_BATCHES),
        ("structured_tex +textures",
         lambda: structured(objgen.STRUCTURED_TEX_NAME, "nearest"), {},
         chip_smoke.TILE_LAYERS, (chip_smoke.BATCH_SMALL,
                                  chip_smoke.BATCH_LARGE)),
        ("san_miguel_small",
         lambda: chip_smoke.bench_scene("san_miguel_small.obj"), {},
         chip_smoke.TILE_LAYERS, (chip_smoke.BATCH_SMALL,
                                  chip_smoke.BATCH_LARGE)),
    )
    out = {}
    for tag, make, options, layers, eager_sizes in rows:
        scene = make()
        renderer = Renderer(scene.mesh, chip_smoke.W, chip_smoke.H,
                            device=torch.device("cuda:0"),
                            **scene.renderer_options(), **options)
        renderer.render(scene.update(chip_smoke.DT))
        chip_smoke.compare_eager_graph(tag, renderer, scene, card, layers,
                                       eager_sizes=eager_sizes)
        out[tag] = chip_smoke.GRAPH_ROWS[tag]
        del renderer
        torch.cuda.empty_cache()
    return out


def worker(tree: str, tag: str, mode: str) -> int:
    """One run in ``tree``: its kernels, then its phase 5 and its
    bench_torch.py, or its texture rows."""
    sys.path.insert(0, tree)
    os.chdir(tree)
    import torch

    import chip_smoke
    from compute_renderer_torch import _build
    from compute_renderer_torch.bench.profiling import card_line

    card = card_line()
    _build.build_all(sorted(
        os.path.basename(p)[:-3]
        for p in glob.glob(os.path.join("compute_renderer_torch", "csrc",
                                        "*.cu"))))
    if mode in ("--texture", "--bins"):
        try:
            rows = (texture_rows if mode == "--texture" else bins_rows)(
                chip_smoke, card)
        except chip_smoke.SmokeFailure as e:
            print(f"compare_main_path: {tag}: FAILED: {e}", file=sys.stderr)
            return 1
        print("[compare] " + json.dumps({"tree": tag, "card": card,
                                         "rows": rows}), flush=True)
        return 0
    reports = {name: {} for name in chip_smoke.KERNELS}
    try:
        chip_smoke.phase_main_path(torch.device("cuda:0"), card, reports)
    except chip_smoke.SmokeFailure as e:
        print(f"compare_main_path: {tag}: FAILED: {e}", file=sys.stderr)
        return 1
    row = chip_smoke.GRAPH_ROWS["suzanne"]
    proc = subprocess.run([sys.executable, "bench_torch.py"],
                          capture_output=True, text=True)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        print(f"compare_main_path: {tag}: bench_torch.py failed:\n"
              f"{proc.stderr[-2000:]}", file=sys.stderr)
        return 1
    print("[compare] " + json.dumps({
        "tree": tag, "card": card, "graph": row["graph"],
        "eager": row["eager"], "bench_torch": json.loads(lines[-1])}),
        flush=True)
    return 0


def main() -> int:
    modes = [a for a in sys.argv[1:] if a in ("--texture", "--bins")]
    args = [a for a in sys.argv[1:] if a not in modes]
    if len(modes) > 1:
        print(__doc__, file=sys.stderr)
        return 2
    mode = modes[0] if modes else ""
    if len(args) == 3 and args[0] == "--worker":
        return worker(os.path.abspath(args[1]), args[2], mode)
    if len(args) != 1:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(args[0])
    results = []
    for tree, tag in ((other, "other"), (ROOT, "this"), (ROOT, "this"),
                      (other, "other")):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             tag] + modes, capture_output=True, text=True)
        sys.stdout.write("".join(
            ln + "\n" for ln in proc.stdout.splitlines()
            if ln.startswith(("[compare]", "[bench]", "[profile]",
                              "[main]"))))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return 1
        results += [json.loads(ln[len("[compare] "):])
                    for ln in proc.stdout.splitlines()
                    if ln.startswith("[compare] ")]
    if mode:
        print("tree | row | graph slope ms | busy ms (kernels) | idle | "
              "eager slope ms (busy, kernels) | card")
        for r in results:
            for row, m in r["rows"].items():
                g, e = m["graph"], m["eager"]
                print(f"{r['tree']} | {row} | {g['slope_ms']:.6f} | "
                      f"{g['busy_ms']:.6f} ({g['kernels']:.2f}) | "
                      f"{g['idle']:.4f} | {e['slope_ms']:.6f} "
                      f"({e['busy_ms']:.6f}, {e['kernels']:.2f}) | "
                      f"{r['card']}")
        return 0
    print("tree | graph slope ms | busy ms (kernels) | idle | eager slope "
          "ms (busy, kernels) | bench_torch.py ms | card")
    for r in results:
        g, e = r["graph"], r["eager"]
        print(f"{r['tree']} | {g['slope_ms']:.6f} | {g['busy_ms']:.6f} "
              f"({g['kernels']:.2f}) | {g['idle']:.4f} | "
              f"{e['slope_ms']:.6f} ({e['busy_ms']:.6f}, "
              f"{e['kernels']:.2f}) | {r['bench_torch']['value']} | "
              f"{r['card']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
