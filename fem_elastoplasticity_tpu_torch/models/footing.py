"""Drucker-Prager strip footing (benchmark B).

Port of `fem_elastoplasticity_tpu/models/footing.py` for the dense solver
in native precision: `FootingConfig()` (f64, the parity run) and
`FootingConfig.fast_f32()` (f32, the return map in kernel K2).  A rigid
footing (inhomogeneous Dirichlet on the top edge, x <= 1.0001) is pushed
into a near-incompressible (nu = 0.48) elastoplastic half-space; the load
factor ramps adaptively with the reference's pressure-based d_zeta
doubling rule (`Plasticity2D_DP/pythonFEM.py:1109-1110`).  Anchors of the
f64 run: 16 accepted steps, zeta ending at 1.032, the reference's pressure
curve within 1e-4.  The f32 run may take another schedule; its limit
pressure agrees with the f64 one to ~1e-4.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..mesh.structured import Mesh, square_mesh
from ..ops import assembly as asm
from ..ops.elements import volume_element
from ..solve.newton import NewtonSettings, build_load_stepper
from ..utils.precision import dtype_policy, resolve_device
from .config import FootingConfig
from .materials import drucker_prager_fit, elastic_tangent_lanes, lame_moduli


class FootingResult(NamedTuple):
    """Solve result at the API edge: float64 numpy arrays."""

    u: np.ndarray  # (n_n, 2)
    ep: np.ndarray  # (4, n_int)
    zeta_hist: np.ndarray
    pressure_hist: np.ndarray  # normalized mean footing pressure (P:1105-1107)
    n_steps: int
    n_newton_total: int
    n_plastic: int
    mesh: Mesh
    n_cg_total: int = 0


def build_mesh(cfg: FootingConfig) -> Mesh:
    """Footing mesh + BCs (`Plasticity2D_DP/pythonFEM.py:175-184`)."""
    mesh = square_mesh(cfg.level, cfg.etype, cfg.size_xy)
    coords = mesh.coords
    footing = (coords[:, 1] == cfg.size_xy) & (coords[:, 0] <= 1.0001)
    dirichlet = np.zeros((mesh.n_nodes, 2))
    dirichlet[footing, 1] = 1.0
    free = coords > 0.0
    free[footing, 1] = False
    free[coords[:, 0] == cfg.size_xy, 0] = False
    mesh.dirichlet = dirichlet
    mesh.free = free
    return mesh


def solve(cfg: FootingConfig = FootingConfig(), device=None) -> FootingResult:
    """Run the footing benchmark: elastic predictor with the inhomogeneous
    Dirichlet load, then the adaptive load-stepped Newton.

    `device`: where to run (`utils.precision.resolve_device`).  In float32
    the elastic Cholesky factor is reused while no point is plastic (the
    JAX package enables the reuse for f32 only).
    """
    device = resolve_device(device)
    policy = dtype_policy(cfg.precision, cfg.dtype)
    dtype = policy.state
    mesh = build_mesh(cfg)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)

    fmap, n_free = asm.free_dof_map(mesh.free)
    free_idx = torch.as_tensor(np.nonzero(mesh.free.reshape(-1))[0], device=device)
    coords = torch.as_tensor(mesh.coords, dtype=dtype, device=device)
    geom = asm.compute_geometry(coords, mesh.elems, volume_element(cfg.etype))
    plan = asm.dense_free_plan(geom, fmap, n_free)
    nmap = asm.node_gather_map(geom)
    dirichlet = torch.as_tensor(mesh.dirichlet.reshape(-1), dtype=dtype, device=device)
    footing = torch.as_tensor(mesh.dirichlet[:, 1] > 0, device=device)
    n_footing = int((mesh.dirichlet[:, 1] > 0).sum())
    # a tensor divisor: PyTorch on CUDA divides by a Python scalar through
    # its rounded reciprocal
    scale = torch.full((), n_footing * cfg.cohesion, dtype=dtype, device=device)

    settings = NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=1,  # the reference starts its history at index 1 (P:1025)
        max_trips=cfg.max_trips,
    )

    # elastic predictor with inhomogeneous Dirichlet (P:996-1004):
    # ud = -d_zeta * dirichlet; K u = -K ud on the free DOFs
    ud = -cfg.d_zeta * dirichlet
    D = elastic_tangent_lanes(shear, bulk, geom.n_int, dtype, device)
    f = -asm.tangent_matvec(geom, D, ud)
    K_free = asm.assemble_dense_free(asm.element_stiffness(geom, D), plan)
    L = torch.linalg.cholesky(K_free)
    U_it0 = ud.clone()
    U_it0[free_idx] = torch.cholesky_solve(f[free_idx, None], L)[:, 0]

    def monitor(u, s):
        # normalized mean footing pressure: -mean over the footing nodes of
        # the nodal projection of s_yy, / cohesion (P:1105-1107)
        p_node = asm.project_to_nodes(geom, s[1], nmap)
        return -torch.where(footing, p_node, torch.zeros_like(p_node)).sum() / scale

    # the criterion is compared in the tangent dtype, against the
    # tolerance rounded the same way (solve/newton.py as_tdtype)
    tol = float(torch.tensor(cfg.newton_tol, dtype=policy.tangent))

    def accept_hook(pressure, pressure_old, crit):
        # double d_zeta while the pressure curve is still flat and Newton
        # converged tightly (P:1109-1110); the increment in the state dtype
        grow = float(pressure - pressure_old) < 0.1 and crit < tol
        return pressure, 2.0 if grow else 1.0

    stepper = build_load_stepper(
        geom, free_idx, plan, shear, bulk, eta, c, settings,
        monitor=monitor, accept_hook=accept_hook,
        apex_ep_uses_trial=cfg.bug_compatible_apex,
        dense_mode=cfg.dense_mode,
        elastic_factor=("cho", L) if dtype == torch.float32 else None,
    )
    res = stepper(U_it0, 0.0, cfg.d_zeta)
    f64 = lambda t: t.detach().to("cpu", torch.float64).numpy()  # noqa: E731
    return FootingResult(
        u=f64(res.u).reshape(-1, 2),
        ep=f64(res.ep),
        zeta_hist=f64(res.zeta_hist),
        pressure_hist=f64(res.monitor_hist),
        n_steps=int(res.n_steps) - 1,  # the step counter started at 1
        n_newton_total=int(res.n_newton_total),
        n_plastic=int(res.n_plastic),
        mesh=mesh,
    )
