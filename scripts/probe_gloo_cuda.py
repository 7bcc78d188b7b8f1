#!/usr/bin/env python3
"""Which collectives a gloo group takes CUDA tensors in, and what a frame's
gather costs, for ranks that share one card.

    python3 scripts/probe_gloo_cuda.py [--ranks 4]

Spawns the ranks with ``compute_renderer_torch.parallel.launch`` (backend
"gloo", every rank on cuda:0) and tries, on CUDA tensors, the three
collectives ``parallel/`` uses — ``all_to_all_single``,
``all_gather_into_tensor`` (int32, uint8, float32) and ``all_reduce``
(MAX) — then times the gather of a 1024x768 RGBA frame a rank (3 MiB of
uint8) five times as gloo does it on the CUDA tensors and five times
staged through host tensors by hand. Prints one JSON line of rank 0's
results and the card's name and power limit.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FRAME_BYTES = 1024 * 768 * 4
CALLS = 5


def probe(rank, world):
    import torch
    import torch.distributed as dist

    dev = torch.device("cuda", 0)
    res = {}

    def ints(n, dtype=torch.int32):
        return torch.arange(n, dtype=dtype, device=dev)

    tries = {
        "all_to_all_single": lambda: dist.all_to_all_single(
            torch.empty(world * 4, dtype=torch.int32, device=dev),
            ints(world * 4)),
        "all_reduce_max": lambda: dist.all_reduce(ints(2),
                                                  op=dist.ReduceOp.MAX),
    }
    for dtype in (torch.int32, torch.uint8, torch.float32):
        tries[f"all_gather_into_tensor_{dtype}"] = (
            lambda dtype=dtype: dist.all_gather_into_tensor(
                torch.empty(world * 4, dtype=dtype, device=dev),
                torch.ones(4, dtype=dtype, device=dev)))
    for name, fn in tries.items():
        try:
            fn()
            torch.cuda.synchronize()
            res[name] = "takes CUDA tensors"
        except Exception as e:  # the probe's answer, not a fall-back
            res[name] = f"refuses: {type(e).__name__}: {e}"[:200]
        dist.barrier()
    frame = torch.zeros(FRAME_BYTES, dtype=torch.uint8, device=dev)
    out = torch.empty(world * FRAME_BYTES, dtype=torch.uint8, device=dev)
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        dist.all_gather_into_tensor(out, frame)
    torch.cuda.synchronize()
    res["gather_cuda_ms"] = (time.perf_counter() - t0) * 1e3 / CALLS
    dist.barrier()
    t0 = time.perf_counter()
    for _ in range(CALLS):
        host = torch.empty(world * FRAME_BYTES, dtype=torch.uint8)
        dist.all_gather_into_tensor(host, frame.cpu())
        out.copy_(host)
    torch.cuda.synchronize()
    res["gather_staged_ms"] = (time.perf_counter() - t0) * 1e3 / CALLS
    return res if rank == 0 else None


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=4)
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("probe_gloo_cuda: needs an NVIDIA GPU", file=sys.stderr)
        return 2
    from compute_renderer_torch.bench.profiling import card_line
    from compute_renderer_torch.parallel import launch

    res = launch(probe, args.ranks, backend="gloo", device="cuda")[0]
    print(json.dumps(dict(ranks=args.ranks, frame_bytes=FRAME_BYTES,
                          **res)))
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
