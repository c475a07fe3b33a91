"""Scaling sweep: the BASELINE "10k -> 1M elements" config.

Port of `fem_elastoplasticity_tpu/benchmarks/solve_sweep.py`.  At each
refinement level of the tsx mesh it times two device computations, in f64:

  * `elastic_cg`  — the matrix-free PCG solve of the elastic excavation
    predictor K u = -F0 (the initial-stress force, then PCG at 1e-12
    relative tolerance), preconditioned by the geometric multigrid V-cycle
    of the tsx's `solver="mg"` (`models.tsx_tunnel._mg_preconditioner`:
    damped block-Jacobi on each level's matrix-free tangent product, level
    0 solved by the Cholesky factor of its dense free-DOF stiffness; the
    fixed-trip "scan" CG of 40 trips) or by 2x2 block-Jacobi ("while" CG,
    at most 1000 iterations), and
  * `newton_iter` (opt-in) — one semi-smooth Newton iteration: strains,
    the Drucker-Prager return map (`dp_return_map_lanes`, f64), the
    internal force, then the block-Jacobi CG tangent solve.

The host builds each level's mesh, geometry and preconditioner (the
hierarchy, its levels' smoothers and the coarse factor) once (`setup_s`,
not timed).  The walls are `utils.timing.time_call` medians:
CG reads its iteration count, and in the "while" form its stopping test,
back from the card, so the calls cannot be captured in a CUDA graph.  No
kernel of the port's own runs here.

    python -m fem_elastoplasticity_tpu_torch.benchmarks.solve_sweep [--cpu]
"""
from __future__ import annotations

import json
import sys
import time
from typing import List

import torch

from ..models.materials import (
    dp_return_map_lanes,
    drucker_prager_fit,
    elastic_tangent_lanes,
    lame_moduli,
)
from ..models import tsx_tunnel as tsx
from ..models.config import TsxTunnelConfig
from ..models.tsx_tunnel import initial_state, tsx_mesh
from ..ops import assembly as asm
from ..ops.elements import ElementType, volume_element
from ..solve.cg import block_jacobi_preconditioner, solve_cg, stiffness_block_jacobi
from ..utils.precision import resolve_device
from ..utils.timing import time_call


def run_solve_sweep(
    levels=(0, 1, 2, 3), reps: int = 3, verbose=True, time_newton: bool = False,
    preconditioner: str = "mg", device=None,
) -> List[dict]:
    """preconditioner: "mg" (geometric multigrid V-cycle; mesh-independent
    iteration counts) or "jacobi" (2x2 block-Jacobi)."""
    if preconditioner not in ("mg", "jacobi"):
        raise ValueError(f"preconditioner must be 'mg' or 'jacobi'; got {preconditioner!r}")
    device = resolve_device(device)
    f64 = torch.float64
    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    s0, e0 = initial_state(cfg)
    ref = volume_element(ElementType.P1)
    e0_t = torch.as_tensor(e0, dtype=f64, device=device)

    results = []
    for level in levels:
        t0 = time.perf_counter()
        mesh = tsx_mesh(ElementType.P1, refine_levels=level)
        geom = asm.compute_geometry(torch.as_tensor(mesh.coords, device=device), mesh.elems, ref)
        free = torch.as_tensor(mesh.free, device=device)
        D = elastic_tangent_lanes(shear, bulk, geom.n_int, f64, device)
        s0f = torch.as_tensor(s0[:3], dtype=f64, device=device)[:, None].expand(3, geom.n_int)
        if preconditioner == "mg":
            pre = tsx._mg_preconditioner(TsxTunnelConfig(solver="mg", refine_levels=level),
                                         mesh, f64, device)
        else:
            pre = block_jacobi_preconditioner(asm.node_block_diagonal(geom, D), free)
        setup = time.perf_counter() - t0

        def elastic_cg():
            f0 = asm.internal_force(geom, s0f)
            return solve_cg(
                lambda v: asm.tangent_matvec(geom, D, v), -f0, free, precond=pre,
                tol=1e-12,
                # MG iteration counts are mesh-independent, so the
                # fixed-trip scan form is cheap
                maxiter=40 if preconditioner == "mg" else 1000,
                structure="scan" if preconditioner == "mg" else "while",
            )

        res = elastic_cg()
        u = cfg.d_zeta * res.x
        ep = torch.zeros((4, geom.n_int), dtype=f64, device=device)
        t_cg = time_call(lambda: elastic_cg().x, reps=reps)
        rec = {
            "level": level,
            "n_elems": int(mesh.n_elems),
            "n_dofs": int(2 * mesh.n_nodes),
            "cg_iters": int(res.iters),
            "elastic_cg_s": t_cg,
            "cg_gdof_per_s": 2 * mesh.n_nodes * int(res.iters) / t_cg / 1e9,
            "setup_s": setup,
        }
        if time_newton:
            def newton_iter():
                e3 = asm.strains(geom, u)
                s_, ds = dp_return_map_lanes(e3, ep, shear, bulk, eta, c, e0=e0_t)[:2]
                f_int = asm.internal_force(geom, s_[:3])
                r = solve_cg(lambda v: asm.tangent_matvec(geom, ds, v), -f_int, free,
                             precond=stiffness_block_jacobi(geom, ds, free), tol=1e-12)
                return u + r.x

            rec["newton_iter_s"] = time_call(newton_iter, reps=reps)
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    run_solve_sweep(device="cpu" if "--cpu" in sys.argv else None)
