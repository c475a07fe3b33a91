#!/usr/bin/env python3
"""Digests of the scale solves' displacements, to compare two trees bit for bit.

Runs, on the card, first the two f32 presets through K2 whose digests
`chip_smoke.py` prints in phases 8 and 10, `solve(TsxTunnelConfig.fast_f32())`
and `footing.solve(FootingConfig.fast_f32())` (counts, u[40,0] and the
digest, K2 launches), then the scale solves whose digests `chip_smoke.py` prints
(phases 14, 17 and 21): `solve(TsxTunnelConfig.fast_scale(1))`, and
`build_df32(fast_scale(L))`'s `run()` once for L = 4 and 5; and the
footing's tangent-multigrid preset `FootingConfig.fast_scale(L,
max_trips=3)` at L = 2 and 4 (phases 23 and 25).  For each it prints the steps / Newton / CG /
plastic counts, u[40,0], the sha256 of u's f64 bytes (as `chip_smoke.py`
prints it), the launches of each hand-written kernel, and device memory
(`torch.cuda.max_memory_allocated` after a reset, above what the process
held before): for L = 4 and 5 the setup's peak, what the setup leaves
allocated and the solve's peak; for L = 1 the peak of `solve`.  It ends
with one JSON line.

    python tools/scale_digests.py [--root DIR] [--f32-only]

`--f32-only` stops after the two f32 presets.

DIR is the checkout whose `fem_elastoplasticity_tpu_torch` is imported
(default: the one holding this script), so one command can run an older
tree unpacked beside this one and this tree, and the two lines compare.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import pathlib
import sys
import time

LEVELS = (1, 4, 5)  # the refine levels of chip_smoke.py's scale solves
FOOTING_LEVELS = (2, 4)  # the footing scale levels, three load trips each


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve().parents[1]))
    ap.add_argument("--f32-only", action="store_true")
    args = ap.parse_args()
    root = pathlib.Path(args.root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("scale_digests: no CUDA device visible", file=sys.stderr)
        return 2
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.ops import spmv

    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
    from fem_elastoplasticity_tpu_torch.ops import return_map as rm

    device = torch.device("cuda")
    out = {"root": str(root), "card": torch.cuda.get_device_name(0)}
    for tag, solve in (("tsx_f32", lambda: tsx.solve(TsxTunnelConfig.fast_f32(), device=device)),
                       ("footing_f32", lambda: footing.solve(FootingConfig.fast_f32(),
                                                             device=device))):
        t0 = time.perf_counter()
        rm.LAUNCHES.clear()
        r = solve()
        u = np.ascontiguousarray(r.u, dtype=np.float64)
        rec = dict(
            counts=[r.n_steps, r.n_newton_total, r.n_plastic], u40=float(u[40, 0]),
            u_sha256=hashlib.sha256(u.tobytes()).hexdigest(),
            launches={k: v for k, v in rm.LAUNCHES.items() if v},
            wall_s=time.perf_counter() - t0,
        )
        out[tag] = rec
        print(f"[{tag}] {rec}", flush=True)
    if args.f32_only:
        print(json.dumps(out), flush=True)
        return 0
    for level in LEVELS:
        cfg = TsxTunnelConfig.fast_scale(level)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held, mem = torch.cuda.memory_allocated(), {}
        t0 = time.perf_counter()
        if level == 1:
            spmv.LAUNCHES.clear()
            r = tsx.solve(cfg, device=device)
        else:
            extras = {}
            run, mesh = tsx.build_df32(cfg, device=device, extras=extras)
            torch.cuda.synchronize()
            mem["setup_peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
            mem["after_setup_gib"] = (torch.cuda.memory_allocated() - held) / 2**30
            torch.cuda.reset_peak_memory_stats()
            spmv.LAUNCHES.clear()
            r = tsx._df32_result(run(), mesh, extras)
        torch.cuda.synchronize()
        mem["solve_peak_gib"] = (torch.cuda.max_memory_allocated() - held) / 2**30
        u = np.ascontiguousarray(r.u, dtype=np.float64)
        rec = dict(
            counts=[r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic],
            u40=float(u[40, 0]), u_sha256=hashlib.sha256(u.tobytes()).hexdigest(),
            launches={k: v for k, v in spmv.LAUNCHES.items() if v},
            wall_s=time.perf_counter() - t0, **mem,
        )
        out[f"L{level}"] = rec
        print(f"[L{level}] {rec}", flush=True)
        del r, u
        if level != 1:
            del run, mesh, extras
    for level in FOOTING_LEVELS:
        t0 = time.perf_counter()
        run, _ = footing.build_df32(FootingConfig.fast_scale(level, max_trips=3), device=device)
        spmv.LAUNCHES.clear()
        r = run()
        torch.cuda.synchronize()
        u = np.ascontiguousarray(r.u, dtype=np.float64)
        rec = dict(
            counts=[r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic],
            u_sha256=hashlib.sha256(u.tobytes()).hexdigest(),
            launches={k: v for k, v in spmv.LAUNCHES.items() if v},
            wall_s=time.perf_counter() - t0,
        )
        out[f"footing_L{level}"] = rec
        print(f"[footing L{level}] {rec}", flush=True)
        del run, r, u
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
