#!/usr/bin/env python3
"""Walls and device idle share of sharded runs, N ranks on one card.

For each rank count (2, 3, 4, 8) one spawn (`parallel.sharding.spawn`,
gloo, every rank on cuda:0) runs a few sharded solves, each between
barriers through `sharding.measured` with rank 0 under torch.profiler (the
card's activity only): its wall on rank 0, rank 0's device busy time and
idle share, the all-gathers of all ranks and the wall a gather on rank 0.
Beside them the same configurations on the single card, timed and
profiled the same way in this process.  The runs are cut short where the
profiler's events would cost more than the run (`runs`).  One JSON line
at the end.

    python tools/sharded_profile.py [--counts 2 3 4 8]

N ranks on one card measure the sharded code's cost, not scaling: every
collective stages through the host.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def runs(TsxTunnelConfig, FootingConfig, tsx, footing):
    """{rank count: [(tag, rank function, its config)]}."""
    z3 = TsxTunnelConfig(zeta_max=3 / 17)
    l1 = TsxTunnelConfig.fast_scale(1)
    l4_cut = TsxTunnelConfig.fast_scale(4, max_trips=3)
    foot = FootingConfig.fast(solver="cg", level=2, tangent_mg=True, zeta_max=0.004,
                              max_trips=2)
    return {
        2: [("tsx_cg_z3", tsx.solve_sharded_rank, z3),
            ("scale_L1", tsx.solve_sharded_scale_rank, l1)],
        3: [("tsx_cg_z3", tsx.solve_sharded_rank, z3)],
        4: [("scale_L1", tsx.solve_sharded_scale_rank, l1),
            ("scale_L4_3trips", tsx.solve_sharded_scale_rank, l4_cut)],
        8: [("scale_L1", tsx.solve_sharded_scale_rank, l1),
            ("footing_tmg_L2_2trips", footing.solve_sharded_rank, foot)],
    }


def single(torch, tag, cfg, tsx, footing, device):
    """(wall s, busy s) of the single-card run of a `runs` entry, its setup
    included as in the sharded runs, after one warm-up run."""
    from torch.profiler import ProfilerActivity, profile

    if tag.startswith("tsx_cg"):
        fn = lambda: tsx.solve(type(cfg)(solver="cg", zeta_max=cfg.zeta_max), device=device)  # noqa: E731
    elif tag.startswith("footing"):
        fn = lambda: footing.build_df32(cfg, device=device)[0]()  # noqa: E731
    else:
        fn = lambda: tsx.build_df32(cfg, device=device)[0]()  # noqa: E731
    fn()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    return wall, (1e-6 * sum(e.device_time_total for e in kernels) if kernels else None)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--counts", type=int, nargs="+", default=[2, 3, 4, 8])
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("sharded_profile: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.parallel import sharding
    from fem_elastoplasticity_tpu_torch.utils.precision import resolve_device

    device = resolve_device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    table = runs(TsxTunnelConfig, FootingConfig, tsx, footing)
    out = {"card": card, "single": {}, "sharded": {}}
    uniq = {}
    for rs in table.values():
        for r in rs:
            uniq.setdefault(r[0], r)
    for tag, _, cfg in uniq.values():
        wall, busy = single(torch, tag, cfg, tsx, footing, device)
        idle = None if busy is None else 1.0 - busy / wall
        out["single"][tag] = dict(wall_s=wall, busy_s=busy, idle_share=idle)
        print(f"[single] {tag}: wall {wall:.3f} s, busy {busy} s, idle {idle} | {card}",
              flush=True)
    for n in args.counts:
        jobs = [(sharding.measured, (fn, (cfg,), True)) for _, fn, cfg in table[n]]
        t0 = time.perf_counter()
        res = sharding.spawn(sharding.run_jobs, n, jobs)
        spawn_s = time.perf_counter() - t0
        for (tag, _, _), m in zip(table[n], res):
            r = m["result"]
            per_rank = m["collectives"].get("gathers", 0) / n
            idle = None if m["busy_s"] is None else 1.0 - m["busy_s"] / m["wall_s"]
            rec = dict(wall_s=m["wall_s"], busy_s=m["busy_s"], idle_share=idle,
                       gathers_per_rank=per_rank,
                       ms_per_gather=1e3 * m["wall_s"] / per_rank if per_rank else None,
                       counts=[r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic],
                       launches=m["launches"])
            out["sharded"][f"{tag}_x{n}"] = rec
            print(f"[sharded] {tag} x{n}: wall {m['wall_s']:.3f} s (setup included), busy "
                  f"{m['busy_s']} s, idle {idle}, {per_rank:.0f} gathers a rank "
                  f"({rec['ms_per_gather']} ms a gather at most), counts {rec['counts']} | "
                  f"{card}", flush=True)
        out["sharded"][f"spawn_x{n}_s"] = spawn_s
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
