#!/usr/bin/env python
"""Attribute the golden-frame pixels that the PyTorch port renders more
than 2 LSB away from the JAX package's golden frames.

    JAX_PLATFORMS=cpu python scripts/attribute_golden_pixels.py [--budget S]

The golden frames (tests/golden_data/torch_ext_structured_1024x768.npz and
torch_mip_structured_1024x768.npz) were rendered by compiled JAX on the
CPU, where XLA contracts mul+add pairs into FMAs. The port's kernels are
bitwise equal to its torch twins on the card, and the twins compute the
JAX package's arithmetic op by op without contraction. So a pixel more
than 2 LSB off should be one where contraction moves a value: the FMA
class of PARITY.md. The script checks that, pixel by pixel:

1. renders every row of both files through the port's CPU twins
   (``Renderer(device="cpu")``) and lists each pixel more than 2 LSB off
   its golden frame;
2. for each row with such a pixel, renders the same frames with the JAX
   package's chain under ``jax.disable_jit()`` — every op run alone, so
   nothing is contracted, Pallas in interpret mode — through the golden
   scripts' own ``render_row``, in a child process stopped after
   ``--budget`` seconds (default 1200);
3. prints, for each listed pixel, the golden, the op-by-op JAX and the
   twin RGBA: a pixel where the twin equals the op-by-op render is of the
   FMA class; one where they differ is a fault of the port.

Writes the pixel lists and the verdicts as JSON to --out (default
build/attribute_golden_pixels.json). Run from the repository root on a
CPU machine with JAX.
"""

import argparse
import json
import multiprocessing as mp
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import numpy as np  # noqa: E402

W, H, DT = 1024, 768, 1.0 / 60.0
EYE = (13.566635, 4.0, 24.0)
GOLDEN = {
    "ext": os.path.join(ROOT, "tests", "golden_data",
                        "torch_ext_structured_1024x768.npz"),
    "mip": os.path.join(ROOT, "tests", "golden_data",
                        "torch_mip_structured_1024x768.npz"),
}
OUT = os.path.join(ROOT, "build", "attribute_golden_pixels.json")


def rows():
    """(file, row, scene options, renderer options) of every golden row,
    as the golden scripts configure them."""
    import make_torch_ext_golden as ext
    import make_torch_mip_golden as mip

    out = []
    for row, (model, options, _) in ext.ROWS.items():
        out.append(("ext", row, dict(model_path=model, **options), {}))
    for row, (model, tex_filter, tex_mode, _, _) in mip.ROWS.items():
        out.append(("mip", row, dict(model_path=model, enable_textures=True,
                                     texture_filter=tex_filter),
                    {"tex_mode": tex_mode}))
    return out


def twin_frames(scene_options, renderer_options, frames):
    """The port's frames of a row through its CPU twins."""
    from compute_renderer_torch import CameraConfig, Scene, SceneConfig
    from compute_renderer_torch.engine.renderer import Renderer

    scene = Scene.from_config(SceneConfig(
        camera_config=CameraConfig.first_person(EYE), **scene_options), W, H)
    renderer = Renderer(scene.mesh, W, H, device="cpu",
                        **scene.renderer_options(), **renderer_options)
    return np.stack([renderer.render(scene.update(DT))
                     for _ in range(frames)])


def far_pixels(a, b, lsb=2):
    """(frame, y, x) of each pixel more than ``lsb`` apart."""
    d = np.abs(a.astype(np.int32) - b.astype(np.int32)).max(axis=-1)
    return [tuple(int(v) for v in p) for p in np.argwhere(d > lsb)]


def _jax_row(kind, row, frames, queue):
    """Child process: the golden script's render_row under disable_jit."""
    import jax

    if kind == "ext":
        import make_torch_ext_golden as script

        model, options, _ = script.ROWS[row]
        args = (model, options, frames)
    else:
        import make_torch_mip_golden as script

        script._spy(script.pallas_raster, "raster_shade_tiles", "tile")
        script._spy(script.pallas_micro, "raster_shade_micro", "micro")
        model, tex_filter, tex_mode, _, expect = script.ROWS[row]
        args = (model, tex_filter, tex_mode, frames, expect)
    t0 = time.perf_counter()
    with jax.disable_jit():
        out, _ = script.render_row(*args)
    queue.put((out, time.perf_counter() - t0))


def jax_op_by_op(kind, row, frames, budget):
    """(frames, seconds) of the JAX chain run op by op, or (None, budget)
    when it does not finish within ``budget`` seconds."""
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    proc = ctx.Process(target=_jax_row, args=(kind, row, frames, queue))
    proc.start()
    try:
        out, secs = queue.get(timeout=budget)
    except Exception:  # queue.Empty: out of time
        out, secs = None, budget
    proc.join(timeout=10)
    if proc.is_alive():
        proc.kill()
        proc.join()
    return out, secs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget", type=float, default=1200.0,
                    help="seconds for each row's op-by-op JAX render")
    ap.add_argument("--rows", nargs="*", help="only these rows")
    ap.add_argument("--out", default=OUT)
    args = ap.parse_args()

    report = []
    for kind, row, scene_options, renderer_options in rows():
        if args.rows and row not in args.rows:
            continue
        golden = np.load(GOLDEN[kind])[row]
        t0 = time.perf_counter()
        twin = twin_frames(scene_options, renderer_options, golden.shape[0])
        far = far_pixels(golden, twin)
        ndiff = int((np.abs(golden.astype(np.int32) - twin) > 0)
                    .any(axis=-1).sum())
        print(f"[twin] {kind} {row}: {golden.shape[0]} frames in "
              f"{time.perf_counter() - t0:.1f} s, {ndiff} px differ from "
              f"golden, {len(far)} by more than 2 LSB: {far}", flush=True)
        entry = {"file": kind, "row": row, "differ": ndiff, "far": []}
        report.append(entry)
        if not far:
            continue
        frames = max(f for f, _, _ in far) + 1
        ref, secs = jax_op_by_op(kind, row, frames, args.budget)
        if ref is None:
            print(f"[jax] {kind} {row}: the op-by-op render did not finish "
                  f"in {args.budget:.0f} s; pixels left open", flush=True)
            entry["jax_seconds"] = None
            for f, y, x in far:
                entry["far"].append({"pixel": [f, y, x],
                                     "golden": golden[f, y, x].tolist(),
                                     "twin": twin[f, y, x].tolist(),
                                     "verdict": "open"})
            continue
        entry["jax_seconds"] = secs
        whole = far_pixels(ref, twin[:frames], lsb=0)
        worst = int(np.abs(ref.astype(np.int32) - twin[:frames]).max())
        print(f"[jax] {kind} {row}: {frames} op-by-op frames in {secs:.1f} "
              f"s; twin vs op-by-op: {len(whole)} px differ, max {worst} "
              "LSB", flush=True)
        entry["twin_vs_op_by_op_differ"] = len(whole)
        entry["twin_vs_op_by_op_max_lsb"] = worst
        for f, y, x in far:
            same = bool((ref[f, y, x] == twin[f, y, x]).all())
            verdict = "FMA class" if same else "fault"
            entry["far"].append({"pixel": [f, y, x],
                                 "golden": golden[f, y, x].tolist(),
                                 "op_by_op": ref[f, y, x].tolist(),
                                 "twin": twin[f, y, x].tolist(),
                                 "verdict": verdict})
            print(f"[pixel] {kind} {row} frame {f} (y={y}, x={x}): golden "
                  f"{golden[f, y, x].tolist()}, op by op "
                  f"{ref[f, y, x].tolist()}, twin {twin[f, y, x].tolist()}"
                  f" -> {verdict}", flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as fh:
        json.dump(report, fh, indent=1)
    print(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
