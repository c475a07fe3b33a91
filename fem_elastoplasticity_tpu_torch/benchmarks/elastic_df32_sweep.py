"""Elastic excavation solves at scale on the df32 fast path.

Port of `fem_elastoplasticity_tpu/benchmarks/elastic_df32_sweep.py`.  At
each refinement level of the tsx mesh, one f64-grade elastic solve
K u = -F0: three passes of iterative refinement
(`ops.assembly_df.refine_elastic_solve_with`), each the residual in f64
(`elastic_apply`, matrix-free) and an f32 correction by matrix-free PCG
preconditioned by the geometric multigrid V-cycle (the "scan" CG of 16
trips at tolerance 2e-7; the tsx's `solver="mg"` V-cycle in f32, its
hierarchy built from f32 coordinates, level 0 solved by the Cholesky
factor of its free-DOF stiffness).
This answers the reference's dense elastic pipeline
(`Elasticity2D/pythonFEM.py:1151-1159`).

Accuracy gate: where the f64 solve is cheap, the refined solution is held
against it (`u_max`; tests/test_torch_benchmarks.py).

The host builds the mesh, the f64 geometry and its f32 heads, the
hierarchy, its levels and the coarse factor (`setup_s`); the timed call is
the device work of the three passes (`compile_plus_first_s` the first,
`wall_s` the median of `reps` more), each ended by `utils.timing.host_sync`.
CG reads its iteration count back, so these are host walls.  No kernel of
the port's own runs here.

    python -m fem_elastoplasticity_tpu_torch.benchmarks.elastic_df32_sweep [levels...] [--cpu]
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..models.materials import elastic_tangent_lanes, lame_moduli
from ..models import tsx_tunnel as tsx
from ..models.config import TsxTunnelConfig
from ..models.tsx_tunnel import initial_state, tsx_mesh
from ..ops import assembly as asm
from ..ops import assembly_df as adf
from ..ops.elements import ElementType, volume_element
from ..solve.cg import solve_cg
from ..utils.precision import resolve_device
from ..utils.timing import host_sync

IR_PASSES = 3


def refined_solve(geom: asm.Geometry, free: torch.Tensor, s0: np.ndarray, cg_op, precond,
                  shear: float, bulk: float):
    """K u = -F0 on the f64 geometry `geom` by IR_PASSES passes of iterative
    refinement, each correction an f32 PCG solve (`cg_op`, `precond`; scan,
    tol 2e-7, 16 trips): returns (u f64, CG iterations of each pass)."""
    s0f = torch.as_tensor(s0[:3], dtype=geom.B.dtype, device=geom.B.device)
    f0 = asm.internal_force(geom, s0f[:, None].expand(3, geom.n_int))
    iters = []

    def correction(r32):
        res = solve_cg(cg_op, r32, free, precond=precond, tol=2e-7, maxiter=16,
                       structure="scan")
        iters.append(int(res.iters))
        return res.x

    u = adf.refine_elastic_solve_with(
        lambda v: adf.elastic_apply(geom, v, shear, bulk), correction,
        torch.zeros_like(f0), -f0, iters=IR_PASSES)
    return u, iters


def timed_record(level: int, n_elems: int, n_dofs: int, setup: float, run, reps: int) -> dict:
    """Run `run()` -> (u, iterations a pass) once and `reps` more times:
    the sweeps' record."""
    t0 = time.perf_counter()
    u, cg_iters = run()
    host_sync(u)
    t_first = time.perf_counter() - t0
    walls = []
    for _ in range(reps):
        t0 = time.perf_counter()
        host_sync(run()[0])
        walls.append(time.perf_counter() - t0)
    return {
        "level": level,
        "n_elems": int(n_elems),
        "n_dofs": int(n_dofs),
        "wall_s": float(np.median(walls)) if walls else t_first,
        "setup_s": setup,
        "compile_plus_first_s": t_first,
        "cg_iters_per_ir_pass": cg_iters,
        "u_max": float(u.abs().max()),
    }


def run_elastic_df32_sweep(levels=(0, 1, 2, 3, 4), reps: int = 3, verbose=True, device=None):
    device = resolve_device(device)
    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    s0, _ = initial_state(cfg)
    ref = volume_element(ElementType.P1)
    f32 = torch.float32

    results = []
    for level in levels:
        t0 = time.perf_counter()
        mesh = tsx_mesh(ElementType.P1, refine_levels=level)
        geom = asm.compute_geometry(torch.as_tensor(mesh.coords, device=device), mesh.elems, ref)
        geom32 = geom.to(f32)  # the f32 heads of the f64 geometry
        free = torch.as_tensor(mesh.free, device=device)
        D = elastic_tangent_lanes(shear, bulk, geom.n_int, f32, device)
        # the f32 V-cycle of the hierarchy built from f32 coordinates
        pre = tsx._mg_preconditioner(TsxTunnelConfig(solver="mg", refine_levels=level), mesh,
                                     f32, device)
        host_sync(D)
        t_setup = time.perf_counter() - t0

        def run():
            return refined_solve(geom, free, s0, lambda v: asm.tangent_matvec(geom32, D, v), pre,
                                 shear, bulk)

        rec = timed_record(level, mesh.n_elems, 2 * mesh.n_nodes, t_setup, run, reps)
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    lv = tuple(int(x) for x in sys.argv[1:] if x != "--cpu") or (0, 1, 2, 3, 4)
    run_elastic_df32_sweep(levels=lv, device="cpu" if "--cpu" in sys.argv else None)
