#!/usr/bin/env python3
"""The readings that the check's limits are set from, on the card.

    python3 frame_bench/control.py --workload san_miguel.batch \\
        --seeds 12 --seconds 2 --control-seeds 3

For each of ``--seeds`` seeds, one short run of the cell's timed path
(``harness.run``) gives the program's ``bad_px`` (the lower reading).
For each of ``--control-seeds`` seeds, the control gives its ``bad_px``
(the upper reading): the reference computed in bfloat16, the precision
below the configuration's float32, put in the program's place, against
the float32 reference on poses the cell's path shows, in the shading the
configuration names (its Kd, its images sampled by its ``tex_filter``).
Prints one JSON line a reading and a summary. The benchmark's own runs
do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def control_poses(path, seed, count):
    """``count`` poses of the cell's path drawn from ``seed``: frames of
    the look-around, or ticks of the viewer's path within its first
    hundred periods."""
    import numpy as np

    rng = np.random.default_rng([int(seed), 11])
    if hasattr(path, "pose_index"):
        return [path.pose(path.pose_index(int(j)))
                for j in rng.integers(0, 100 * path.period, count)]
    ticks = [int(g) for g in rng.integers(0, 100 * path.period, count)]
    poses = path.poses(ticks)
    return [poses[g] for g in ticks]


def control_reading(config, traffic, seed, count, device):
    """The control's worst ``bad_px`` over ``count`` poses: bfloat16
    reference frames against float32 ones."""
    import torch

    from frame_bench.reference import camera as cam
    from frame_bench.reference import objscene
    from frame_bench.reference import render as ref
    from frame_bench import harness

    arrays = harness.build_scene(config)
    if isinstance(arrays, objscene.ObjScene):
        arrays.remove_files()
    scene = harness.reference_scene(config, arrays, device)
    if traffic["loop"] == "batch":
        path = cam.LookAround(traffic["camera"], config["camera"],
                              float(traffic["dt"]), seed)
    else:
        path = cam.interactive_path(traffic["camera"], config["camera"],
                                    float(traffic["dt"]), seed)
    W, H = config["width"], config["height"]
    worst = 0
    for pose in control_poses(path, seed, count):
        vpos, vp = pose.matrices(W / H)
        args = (scene, vpos, vp, config["lights"], W, H)
        kwargs = {"cell": config["cell"],
                  "tex_filter": config.get("tex_filter", "nearest")}
        exact = ref.render(*args, **kwargs)
        low = ref.render(*args, **kwargs, dtype=torch.bfloat16)
        worst = max(worst, harness.bad_pixels(low, exact))
    return worst


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--first-seed", type=int, default=2_200_000_000)
    parser.add_argument("--seconds", type=float, default=2.0)
    parser.add_argument("--control-seeds", type=int, default=3)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch

    from frame_bench import harness

    bench = harness.load_bench()
    cell = next(c for c in bench["workloads"] if c["name"] == args.workload)
    config = harness.load_json("configs", cell["config"])
    traffic = harness.load_json("traffic", cell["traffic"])
    limits = harness.load_json("limits", args.workload)
    program = []
    for k in range(args.seeds):
        seed = args.first_seed + 7919 * k
        t0 = time.perf_counter()
        _, numbers = harness.run(args.workload, seed, args.seconds, 0,
                                 bench=bench, device="cuda")
        program.append(numbers["bad_px"][0])
        print(json.dumps({"side": "program", "seed": seed,
                          "numbers": numbers,
                          "seconds": time.perf_counter() - t0}), flush=True)
    control = []
    for k in range(args.control_seeds):
        seed = args.first_seed + 104729 * (k + 1)
        reading = control_reading(config, traffic, seed,
                                  int(traffic["samples"]),
                                  torch.device("cuda"))
        control.append(reading)
        print(json.dumps({"side": "control", "seed": seed,
                          "bad_px": reading}), flush=True)
    print(json.dumps({"workload": args.workload, "program_max": max(program),
                      "program": program, "control_min": min(control),
                      "control": control, "limit": limits["bad_px"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
