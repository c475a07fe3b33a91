#!/usr/bin/env python3
"""Time the collectives of `parallel/sharding.py` with N ranks on one card.

Each rank count (default 2, 4, 8) is one spawn (`sharding.spawn`, gloo,
every rank on cuda:0).  For each message size (f32 elements a rank) it
times, over `--reps` calls after 5 warm-up calls, between barriers on
rank 0's host clock: an all_gather of CUDA tensors (with the
concatenation), a gather to rank 0 followed by a broadcast (the route
`ShardGroup` takes for small messages over more than two ranks, its
`SMALL_GATHER`), and a barrier alone.  Milliseconds a call, one line a
rank count.

    python tools/gather_bench.py [--counts 2 4 8] [--sizes 952 456224] [--reps 200]
"""
from __future__ import annotations

import argparse
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def bench(group, sizes, reps):
    """Rank function: {size: {route: ms a call}}."""
    import torch
    import torch.distributed as dist

    dev = group.device
    out = {}
    for n in sizes:
        x = torch.randn(n, device=dev)
        bufs = [torch.empty_like(x) for _ in range(group.size)]
        flat = torch.empty((group.size, n), device=dev)
        res = {}
        for route in ("all_gather", "gather_broadcast", "barrier"):
            for it in range(reps + 5):
                if it == 5:
                    torch.cuda.synchronize(dev)
                    dist.barrier()
                    t0 = time.perf_counter()
                if route == "all_gather":
                    dist.all_gather(bufs, x)
                    torch.cat(bufs)
                elif route == "gather_broadcast":
                    dist.gather(x, list(flat.unbind(0)) if group.rank == 0 else None, dst=0)
                    dist.broadcast(flat, src=0)
                else:
                    dist.barrier()
            torch.cuda.synchronize(dev)
            res[route] = 1e3 * (time.perf_counter() - t0) / reps
        out[n] = res
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--counts", type=int, nargs="+", default=[2, 4, 8])
    ap.add_argument("--sizes", type=int, nargs="+", default=[952, 456224])
    ap.add_argument("--reps", type=int, default=200)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("gather_bench: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from fem_elastoplasticity_tpu_torch.parallel import sharding

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    for n in args.counts:
        res = sharding.spawn(bench, n, args.sizes, args.reps)
        print(f"{n} ranks ({sharding.placement(n)[1]}): " + "; ".join(
            f"{size} f32 a rank: " + ", ".join(f"{k} {v:.3f} ms" for k, v in r.items())
            for size, r in res.items()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
