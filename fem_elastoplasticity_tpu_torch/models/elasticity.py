"""Linear elasticity on the square with a hole (benchmark A).

Port of `fem_elastoplasticity_tpu/models/elasticity.py`
(`Elasticity2D/pythonFEM.py:1052-1179`).  Anchors (BASELINE.md, from the
reference): stored energy P1 level 1 2786.3472189077, P1 level 2
2717.5492666201, Q2 level 1 2642.1861301492.

The dense solver assembles the free-DOF stiffness (`assemble_dense_free`)
and solves by Cholesky (`torch.linalg.cholesky`, as the JAX package uses
XLA's `cho_factor` here); "cg" runs matrix-free block-Jacobi PCG, so no
matrix exists.  The energy 0.5 u.Ku - f.u uses the matrix-free operator.
No hand-written kernel lies on this path.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..mesh.structured import Mesh, square_with_hole_mesh
from ..ops import assembly as asm
from ..ops.elements import surface_element, volume_element
from ..solve.cg import block_jacobi_preconditioner, solve_cg
from ..utils.precision import resolve_device
from .config import ElasticityConfig
from .materials import elastic_tangent_lanes, lame_moduli


class ElasticityResult(NamedTuple):
    """Solve result at the API edge: numpy arrays and Python numbers."""

    u: np.ndarray  # (n_n, 2) displacements
    energy: float  # stored energy 0.5 u.Ku - f.u
    mesh: Mesh
    cg_iters: int = 0  # iterations of the CG solve (0 with the dense solver)


def build_mesh(cfg: ElasticityConfig) -> Mesh:
    """Mesh and boundary conditions (`Elasticity2D/pythonFEM.py:717-722`):
    u_x prescribed on the y = 0 edge (scaled by `dirichlet_scale` in
    `solve`), a DOF constrained where its own coordinate is 0 (symmetry),
    the traction on the top face."""
    mesh = square_with_hole_mesh(cfg.level, cfg.etype, cfg.size_xy, cfg.size_hole)
    coords = mesh.coords
    dirichlet = np.zeros((mesh.n_nodes, 2))
    dirichlet[coords[:, 1] == 0.0, 0] = 1.0
    free = coords > 0.0
    free[coords[:, 1] == 0.0, 0] = False
    mesh.dirichlet = dirichlet
    mesh.free = free
    return mesh


def solve(cfg: ElasticityConfig = ElasticityConfig(), device=None) -> ElasticityResult:
    """Solve the benchmark; `device` as `utils.precision.resolve_device`."""
    device = resolve_device(device)
    dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
    mesh = build_mesh(cfg)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    ref = volume_element(cfg.etype)
    coords = torch.as_tensor(mesh.coords, dtype=dtype, device=device)
    geom = asm.compute_geometry(coords, mesh.elems, ref)
    D = elastic_tangent_lanes(shear, bulk, geom.n_int, dtype, device)
    K = lambda v: asm.tangent_matvec(geom, D, v)  # noqa: E731

    f_load = (
        asm.traction_force_vector(coords, mesh.neumann, surface_element(cfg.etype),
                                  cfg.traction_force, mesh.n_nodes)
        + asm.volume_force_vector(geom, ref, cfg.volume_force)
    )
    ud = torch.as_tensor(cfg.dirichlet_scale * mesh.dirichlet.reshape(-1), dtype=dtype,
                         device=device)
    # the Dirichlet lift (E:1147): f = f_load - K ud
    f = f_load - K(ud)
    free_flat = mesh.free.reshape(-1)
    iters = 0
    if cfg.solver == "dense":
        fmap, n_free = asm.free_dof_map(mesh.free)
        plan = asm.dense_free_plan(geom, fmap, n_free)
        L = torch.linalg.cholesky(asm.assemble_dense_free(asm.element_stiffness(geom, D), plan))
        free_idx = torch.as_tensor(np.nonzero(free_flat)[0], device=device)
        u = ud.clone()
        u[free_idx] = torch.cholesky_solve(f[free_idx, None], L)[:, 0]
    else:
        free_mask = torch.as_tensor(free_flat, device=device)
        tol = cfg.cg_tol if cfg.cg_tol is not None else (
            2e-7 if dtype == torch.float32 else 1e-12)
        res = solve_cg(K, f, free_mask,
                       precond=block_jacobi_preconditioner(asm.node_block_diagonal(geom, D),
                                                           free_mask),
                       tol=tol, maxiter=cfg.cg_maxiter)
        u, iters = ud + res.x, res.iters
    # stored energy (E:1171)
    energy = 0.5 * u @ K(u) - f_load @ u
    return ElasticityResult(u=u.detach().cpu().double().numpy().reshape(-1, 2),
                            energy=float(energy), mesh=mesh, cg_iters=int(iters))
