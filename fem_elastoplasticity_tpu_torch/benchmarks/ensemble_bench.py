"""64-way material-ensemble benchmark (BASELINE config).

Port of `fem_elastoplasticity_tpu/benchmarks/ensemble_bench.py`.  Batches
the full tsx excavation over an 8x8 (cohesion, friction-angle) grid
(`parallel.ensemble`: shared geometry, member-batched return mapping,
assembly and factorizations) and reports aggregate throughput: solves per
second against the reference's 1.36 s-per-solve serial CPU baseline.  The
f32 preset's return map is K2's member-batched instance; the df32 preset
runs f64 state with f32 tangent solves on the dense solver.

Each wall is the host wall of one call, which returns host arrays and so
ends once the card has finished (the ensemble's controller reads the card
once a sweep): the first call (`first_wall_s`) and a second
(`warm_wall_s`).

    python -m fem_elastoplasticity_tpu_torch.benchmarks.ensemble_bench [--cpu]
    python -m fem_elastoplasticity_tpu_torch.benchmarks.ensemble_bench --scale \\
        [--members=N] [--refine=L] [--cpu]
"""
from __future__ import annotations

import json
import time
from typing import Optional

import numpy as np

from ..models.config import TsxTunnelConfig
from ..parallel.ensemble import material_grid, solve_tsx_ensemble, solve_tsx_ensemble_df32
from ..utils.precision import resolve_device

REFERENCE_SOLVE_S = 1.36  # BASELINE.md measured, per solve


def _walls(solve):
    """(result, first wall s, warm wall s) of two calls of `solve`; the
    ensemble returns host arrays, so a call's return is its end."""
    t0 = time.perf_counter()
    solve()
    first = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = solve()
    return res, first, time.perf_counter() - t0


def run_ensemble_bench(n_cohesion=8, n_friction=8, verbose=True, device=None,
                       extras: Optional[dict] = None) -> dict:
    """`extras`, if given, receives the warm runs' EnsembleResults under
    "f32" and "df32" and the grid under "eta" and "c"."""
    device = resolve_device(device)
    cohesions = np.linspace(14.0, 25.0, n_cohesion)
    frictions = np.deg2rad(np.linspace(40.0, 55.0, n_friction))
    eta, c = material_grid(cohesions, frictions)
    n_b = len(eta)

    # pure-f32 preset: the native ensemble path, K2's batched instance
    cfg = TsxTunnelConfig.fast_f32()
    res, first, warm = _walls(lambda: solve_tsx_ensemble(eta, c, cfg, device=device))
    # df32 preset: every member an f64-grade (1e-12/1e-10 criteria) solve
    cfg_df = TsxTunnelConfig.fast()
    res_df, first_df, warm_df = _walls(lambda: solve_tsx_ensemble_df32(eta, c, cfg=cfg_df,
                                                                       device=device))

    rec = {
        "ensemble_size": int(n_b),
        "first_wall_s": first,
        "warm_wall_s": warm,
        "solves_per_s": n_b / warm,
        "vs_serial_reference": n_b * REFERENCE_SOLVE_S / warm,
        "min_steps": int(np.asarray(res.n_steps).min()),
        "max_steps": int(np.asarray(res.n_steps).max()),
        "df32_first_wall_s": first_df,
        "df32_warm_wall_s": warm_df,
        "df32_solves_per_s": n_b / warm_df,
        "df32_vs_serial_reference": n_b * REFERENCE_SOLVE_S / warm_df,
        "df32_min_steps": int(np.asarray(res_df.n_steps).min()),
        "df32_max_steps": int(np.asarray(res_df.n_steps).max()),
    }
    if extras is not None:
        extras.update(f32=res, df32=res_df, eta=eta, c=c)
    if verbose:
        print(json.dumps(rec), flush=True)
    return rec


def run_ensemble_scale_bench(
    n_members=16, refine_levels=1, zeta_max=1.0, verbose=True, device=None,
    extras: Optional[dict] = None,
) -> dict:
    """Refined-mesh df32 ensemble: full adaptive solves batched over
    materials at refine_levels >= 1 by matrix-free PCG members
    (solver="cg", `parallel/ensemble.py`).  `extras`, if given, receives
    the warm run's EnsembleResult under "df32", the grid under "eta" and
    "c", and the configuration under "cfg"."""
    device = resolve_device(device)
    nc = max(2, int(np.sqrt(n_members)))
    nf = -(-n_members // nc)
    cohesions = np.linspace(14.0, 25.0, nc)
    frictions = np.deg2rad(np.linspace(42.0, 55.0, nf))
    eta, c = material_grid(cohesions, frictions)
    eta, c = eta[:n_members], c[:n_members]
    cfg = TsxTunnelConfig.fast(solver="cg", refine_levels=refine_levels, zeta_max=zeta_max)
    res, first, warm = _walls(lambda: solve_tsx_ensemble_df32(eta, c, cfg=cfg, device=device))
    rec = {
        "ensemble_size": int(len(eta)),
        "refine_levels": int(refine_levels),
        "zeta_max": float(zeta_max),
        "first_wall_s": first,
        "warm_wall_s": warm,
        "solves_per_s": len(eta) / warm,
        "min_steps": int(np.asarray(res.n_steps).min()),
        "max_steps": int(np.asarray(res.n_steps).max()),
    }
    if extras is not None:
        extras.update(df32=res, eta=eta, c=c, cfg=cfg)
    if verbose:
        print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    import sys

    device = "cpu" if "--cpu" in sys.argv else None
    if "--scale" in sys.argv:
        kw = {}
        for a in sys.argv[1:]:
            if a.startswith("--members="):
                kw["n_members"] = int(a.split("=", 1)[1])
            elif a.startswith("--refine="):
                kw["refine_levels"] = int(a.split("=", 1)[1])
        run_ensemble_scale_bench(device=device, **kw)
    else:
        run_ensemble_bench(device=device)
