#!/usr/bin/env python3
"""bench.py's frame in two checkouts of the port, in turns, on one card.

    git archive <commit> | tar -x -C build/other
    python3 scripts/compare_main_path.py build/other

Runs ``chip_smoke.phase_main_path`` (phase 5: Suzanne 1024x768 through
``Renderer``, held to the golden frames and to the eager frames, then the
eager loop against the replayed graph: slopes, busy time, kernels a
frame, idle share) and ``bench_torch.py`` in each checkout, one process a
run (the two packages share a name), in the order other, this, this,
other, so that drift on the card falls on both alike. Each checkout
builds its own kernels into its own ``build/``. Prints one ``[compare]``
JSON line a run, then a table. Needs a CUDA card; a run that fails its
checks fails the script.
"""

import glob
import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(tree: str, tag: str) -> int:
    """One run in ``tree``: its kernels, its phase 5, its bench_torch.py."""
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
    if len(sys.argv) == 4 and sys.argv[1] == "--worker":
        return worker(os.path.abspath(sys.argv[2]), sys.argv[3])
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    other = os.path.abspath(sys.argv[1])
    results = []
    for tree, tag in ((other, "other"), (ROOT, "this"), (ROOT, "this"),
                      (other, "other")):
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             tag], capture_output=True, text=True)
        sys.stdout.write("".join(
            ln + "\n" for ln in proc.stdout.splitlines()
            if ln.startswith(("[compare]", "[bench]", "[profile] suzanne",
                              "[main]"))))
        if proc.returncode != 0:
            sys.stderr.write(proc.stderr[-4000:])
            return 1
        results += [json.loads(ln[len("[compare] "):])
                    for ln in proc.stdout.splitlines()
                    if ln.startswith("[compare] ")]
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
