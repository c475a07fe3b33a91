"""Large-mesh full Drucker-Prager solves: the df32 fast path at scale.

Port of `fem_elastoplasticity_tpu/benchmarks/dp_scale_bench.py`.  Runs
the complete adaptive load-stepped excavation (17-step schedule,
semi-smooth Newton, return map, criterion: everything the bench preset
runs on the parity mesh) on uniformly refined tsx meshes with
`TsxTunnelConfig.fast_scale(level)`: f32 tangent solves by CG
preconditioned by the assembled multigrid V-cycle, the Newton residual
and state in f64 (`precision="df32"`).  Kernels: K1 (the residual's G u and
S s), K3 (the CG operator's product on node blocks, the transfers), K4
(the smoother) and, on levels of 500,000 rows or more (level 5), K5.

This is the scaling axis the reference's dense boolean-masked pipeline
cannot enter (`Elasticity2D/pythonFEM.py:1151-1159` builds the O(n^2)
dense stiffness).

One `build_df32` a level (host setup, `setup_s`), then the whole load loop
in one call of its run: the first (`compile_plus_first_s`: it pays the
kernels' loads and the caching allocator's first requests) and `reps`
more, whose median is `wall_s`.  Each wall ends in `utils.timing.host_sync`
of the result; the loop reads the card every Newton iteration, so walls
are host walls.  u40 is the monitored tunnel-wall u_x at the last
accepted step (the stepper's monitor node, on the solver's node order).

    python -m fem_elastoplasticity_tpu_torch.benchmarks.dp_scale_bench [levels...] [--cpu]
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np

from ..models import tsx_tunnel as tsx
from ..models.config import TsxTunnelConfig
from ..utils.precision import resolve_device
from ..utils.timing import host_sync


def run_dp_scale(
    levels=(1, 2, 3), reps: int = 3, verbose: bool = True, device=None, **cfg_kw
):
    """cfg_kw: extra TsxTunnelConfig.fast_scale overrides (A/B runs,
    e.g. corr_mode="scatter")."""
    device = resolve_device(device)
    results = []
    for level in levels:
        cfg = TsxTunnelConfig.fast_scale(level, **cfg_kw)
        t0 = time.perf_counter()
        run, mesh = tsx.build_df32(cfg, device=device)
        t_setup = time.perf_counter() - t0

        t0 = time.perf_counter()
        res = run()
        host_sync(res.u)
        t_first = time.perf_counter() - t0

        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            res = run()
            host_sync(res.u)
            walls.append(time.perf_counter() - t0)
        wall = float(np.median(walls)) if walls else t_first

        k = int(res.n_steps) - 1
        rec = {
            "level": level,
            "n_elems": int(mesh.n_elems),
            "n_dofs": int(2 * mesh.n_nodes),
            "wall_s": wall,
            "setup_s": t_setup,
            "compile_plus_first_s": t_first,
            "n_steps": int(res.n_steps),
            "n_newton_total": int(res.n_newton_total),
            "n_cg_total": int(res.n_cg_total),
            "n_plastic": int(res.n_plastic),
            "u40": float(res.monitor_hist[k]),
        }
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    lv = tuple(int(x) for x in sys.argv[1:] if x != "--cpu") or (1, 2, 3)
    run_dp_scale(levels=lv, device="cpu" if "--cpu" in sys.argv else None)
