"""Strip-footing DP solves at scale: the df32 CG footing path.

Port of `fem_elastoplasticity_tpu/benchmarks/footing_scale_bench.py`.  The
reference's footing benchmark runs only at level 1 (dense masked solve,
`Plasticity2D_DP/pythonFEM.py:901-1157`); its O(n^2) dense pipeline cannot
represent refined levels.  This runs the complete adaptive
pressure-controlled schedule (semi-smooth Newton, the d_zeta doubling
rule, near-incompressible nu = 0.48) at refined levels with f32
block-Jacobi PCG tangent solves and the f64 residual and criterion
(`FootingConfig.fast(level, solver="cg", cg_maxiter=4000)`: matrix-free, no
kernel of the port's own; with `assembled_cg=True` the elastic node blocks
through K3's product and the residual through K1), or with `scale_preset`
the tangent-multigrid preset `FootingConfig.fast_scale(level)` (K1, K3's
product, transfers and CSR kernel, K4).

Level sizes (P1): level 1 = 800 elems / 441 nodes, 2 = 3.2k / 1.7k,
3 = 12.8k / 6.6k, 4 = 51.2k / 26k, 5 = 204.8k / 103k.

One `build_df32` a level (`setup_s`), then the whole schedule in one call
of its run: the first (`first_incl_compile_s`: it pays the kernels' loads
and the caching allocator's first requests) and `reps` more, whose median
is `wall_s`.  A run returns host arrays, so its wall ends once the card has
finished.

    python -m fem_elastoplasticity_tpu_torch.benchmarks.footing_scale_bench [levels...] \\
        [--scale] [--deflate=K] [--reps=N] [--cpu]
"""
from __future__ import annotations

import json
import sys
import time
from typing import Optional

import numpy as np

from ..models import footing
from ..models.config import FootingConfig
from ..utils.precision import resolve_device


def run_footing_scale(
    levels=(1, 2, 3), reps: int = 3, verbose: bool = True,
    scale_preset: bool = False, device=None, extras: Optional[dict] = None, **cfg_kw
):
    """cfg_kw: extra FootingConfig.fast overrides (A/B runs, e.g.
    assembled_cg=True for the full-tangent node-block path).
    scale_preset: use FootingConfig.fast_scale (the tangent-multigrid
    configuration for level >= 4, module docstring).  `extras`, if given,
    receives each level's last FootingResult and configuration as lists
    under "results" and "configs"."""
    device = resolve_device(device)
    results = []
    for level in levels:
        if scale_preset:
            cfg = FootingConfig.fast_scale(level, **cfg_kw)
        else:
            kw = dict(solver="cg", cg_maxiter=4000)
            kw.update(cfg_kw)
            cfg = FootingConfig.fast(level=level, **kw)
        t0 = time.perf_counter()
        run, _ = footing.build_df32(cfg, device=device)
        setup = time.perf_counter() - t0
        t0 = time.perf_counter()
        r = run()
        first = time.perf_counter() - t0
        walls = []
        for _ in range(reps):
            t0 = time.perf_counter()
            r = run()
            walls.append(time.perf_counter() - t0)
        rec = {
            "level": level,
            "n_elems": int(r.mesh.n_elems),
            "n_dofs": int(2 * r.mesh.n_nodes),
            "wall_s": float(np.median(walls)) if walls else first,
            "first_incl_compile_s": first,
            "setup_s": setup,
            "n_steps": int(r.n_steps),
            "n_newton_total": int(r.n_newton_total),
            "n_cg_total": int(r.n_cg_total),
            "n_plastic": int(r.n_plastic),
            "cg_deflate": int(getattr(cfg, "cg_deflate", 0)),
            "limit_pressure": float(r.pressure_hist[r.n_steps]),
            "zeta_end": float(np.asarray(r.zeta_hist).max()),
        }
        results.append(rec)
        if extras is not None:
            extras.setdefault("results", []).append(r)
            extras.setdefault("configs", []).append(cfg)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    scale = "--scale" in sys.argv
    kw = {}
    for a in sys.argv[1:]:
        if a.startswith("--deflate="):
            kw["cg_deflate"] = int(a.split("=", 1)[1])
        elif a.startswith("--reps="):
            kw["reps"] = int(a.split("=", 1)[1])
    lv = tuple(
        int(x) for x in sys.argv[1:] if not x.startswith("-")
    ) or (1, 2, 3)
    run_footing_scale(levels=lv, scale_preset=scale,
                      device="cpu" if "--cpu" in sys.argv else None, **kw)
