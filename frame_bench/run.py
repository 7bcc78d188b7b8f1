#!/usr/bin/env python3
"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

    python3 frame_bench/run.py --workload san_miguel.batch --seed 7 \\
        --seconds 10 --trace 0

Runs ``compute_renderer_torch`` on one NVIDIA GPU (it exits 2, printing no
result, without one): set-up, then ``--seconds`` of the cell's traffic,
timed; with ``--trace 1`` also a short window under ``torch.profiler``.
Sampled frames of the timed window are then checked against the plain
reference (``reference/render.py``). The last lines on standard error
give each number compared beside its limit; the last line on standard
output is the result, one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer ones), ``device``, with ``--trace 1``
``breakdown``, and last ``check``.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def card_line():
    """The card's name and power limit, or why they could not be read."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        return out.stdout.strip().splitlines()[0].strip()
    except (OSError, subprocess.SubprocessError, IndexError) as exc:
        return f"nvidia-smi unavailable ({exc})"


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    # Every cache at a fixed path inside the checkout: the program builds
    # its kernels into build/torch_kernels/ itself.
    cache = ROOT / "build" / "frame_bench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")

    with open(ROOT / "BENCHMARK.json") as f:
        bench = json.load(f)
    cells = {c["name"]: c for c in bench["workloads"]}
    if args.workload not in cells:
        print(f"frame_bench: no cell {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    import torch

    chips = cells[args.workload]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"frame_bench: needs {chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}",
              file=sys.stderr)
        return 2

    sys.path.insert(0, str(ROOT))
    from frame_bench import harness

    result, numbers = harness.run(args.workload, args.seed, args.seconds,
                                  args.trace, bench=bench, device="cuda",
                                  t_start=T_START)
    found = harness.banned_modules()
    if found:
        print(f"frame_bench: loaded {found}", file=sys.stderr)
        return 3
    print(f"frame_bench: card {card_line()}", file=sys.stderr)
    for name, (value, limit) in numbers.items():
        print(f"{name} {value} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    result["check"] = {name: {"value": value, "limit": limit}
                       for name, (value, limit) in numbers.items()}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
