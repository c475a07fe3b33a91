"""Drucker-Prager strip footing (benchmark B).

Port of `fem_elastoplasticity_tpu/models/footing.py`, for P1, P2, Q1 and
Q2 elements (the tangent multigrid for P1 only).  A rigid footing
(inhomogeneous Dirichlet on the top edge, x <= 1.0001) is pushed into a
near-incompressible (nu = 0.48) elastoplastic half-space; the load factor
ramps adaptively with the reference's pressure-based d_zeta doubling rule
(`Plasticity2D_DP/pythonFEM.py:1109-1110`).

* `solve` runs the native precisions: `FootingConfig()` (f64, the parity
  run) and `FootingConfig.fast_f32()` (f32, the return map in kernel K2),
  with dense tangent solves or, with `solver="cg"`, block-Jacobi PCG on
  the matrix-free tangent; and routes `precision="df32"` to `build_df32`.
* `build_df32` is the double-float preset `FootingConfig.fast()`: f64
  state and residual, f32 tangent solves, dense (the explicit elastic
  inverse and f32 Cholesky factors) or CG; with `assembled_cg=True` the
  CG operator is the assembled elastic stiffness in 2x2 node blocks,
  refreshed from every integration point once per Newton iteration
  (kernel K3's product), and the Newton
  residual runs on the assembled G/S operators (kernel K1), on an RCM node
  ordering whose result is handed back in the reference order; with
  `tangent_mg=True` (`FootingConfig.fast_scale`) CG runs on the fine level
  of a red-refinement hierarchy of the level-1 mesh, preconditioned by its
  V-cycle, every level refreshed from the tangent once a Newton iteration
  (kernels K3 and K4, `solve.multigrid.tangent_vcycle`), the residual on
  G/S (K1), and the result stays on the hierarchy's fine mesh (fine-RCM
  node order), as the JAX package returns it.  `run(resume=carry)`
  continues from a carry (`FootingResult.carry`, or
  `utils.convert.load_checkpoint` of a JAX package checkpoint), and
  `build_df32_chunked` runs a build in chunks of load trips with an
  optional checkpoint file (`solve.chunked`).
* Every CG solve takes `cg_structure` ("while" or "scan", fixed trips).
* `build_df32(shard_devices=...)`, inside a rank of
  `parallel.sharding.spawn` (`solve_sharded`), runs the tangent multigrid
  over several devices: the hierarchy, its Galerkin value maps and G/S
  row-sharded, the fine tangent scatter on each rank's slice of the
  values; the trajectory is the single-device run's bit for bit.

Anchors of the f64 run: 16 accepted steps, zeta ending at 1.032, the
reference's pressure curve within 1e-4; the dense df32 run follows the
same 16-step schedule with u within 1e-9.  The f32 run and the CG runs may
take other schedules; their limit pressures agree with the f64 one to
~5e-4.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..mesh.structured import Mesh, square_mesh
from ..ops import assembly as asm
from ..ops import assembly_df as adf
from ..ops import spmv
from ..ops.elements import volume_element
from ..parallel import sharding
from ..solve import multigrid as mg
from ..solve.cg import plastic_cg_tol, solve_cg, stiffness_block_jacobi
from ..solve.chunked import run_chunked
from ..solve.newton import LoadSteppingResult, NewtonSettings, build_load_stepper, carry_of
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
    newton_trips: tuple = ()  # Newton iterations of each load trip
    crit_trips: tuple = ()  # the last Newton criterion of each load trip
    zeta_trips: tuple = ()  # the accepted load factor after each load trip
    cg_trips: tuple = ()  # each trip's CG solves: ((iterations, converged), ...)
    # df32 runs: the stepper's resume carry (`solve.newton.carry_of`) on the
    # solver's node order, for `run(resume=...)` of the same build
    carry: Optional[dict] = None


# the two-float criterion's floor band, [newton_tol / FLOOR_BAND, newton_tol)
FLOOR_BAND = 10.0


def newton_trip_gaps(r: FootingResult, ref_trips, cfg: FootingConfig) -> list:
    """The load trips where a df32 result `r` departs from the JAX package's
    two-float run of `cfg` (its Newton iterations by trip, `ref_trips`):
    [(trip, r's count, the reference's, r's last criterion), ...], 1-based.

    The port's df32 state is f64, so its criterion settles below the
    two-float one's floor (a few 1e-12).  A trip takes the reference's
    Newton count, or fewer where the reference ends at its floor
    (newton_maxit iterations) or where r's last criterion lies within
    FLOOR_BAND below newton_tol, a value the two-float criterion cannot
    tell from newton_tol.  A schedule of another length is one gap.
    """
    ref = [int(k) for k in ref_trips]
    if len(r.newton_trips) != len(ref):
        return [(len(ref), len(r.newton_trips), len(ref), float("nan"))]
    band = cfg.newton_tol / FLOOR_BAND
    return [(i + 1, got, k, crit)
            for i, (got, k, crit) in enumerate(zip(r.newton_trips, ref, r.crit_trips))
            if not (got == k or (got < k and (k == cfg.newton_maxit or crit >= band)))]


def _free_mask(cfg: FootingConfig, coords: np.ndarray) -> np.ndarray:
    """(n_n, 2) free DOFs (`Plasticity2D_DP/pythonFEM.py:175-184`): the
    footing's vertical DOFs, the symmetry axis x = 0 and the far side
    x = size_xy are constrained."""
    footing = (coords[:, 1] == cfg.size_xy) & (coords[:, 0] <= 1.0001)
    free = coords > 0.0
    free[footing, 1] = False
    free[coords[:, 0] == cfg.size_xy, 0] = False
    return free


def _with_bcs(cfg: FootingConfig, mesh: Mesh) -> Mesh:
    """The mesh with the footing's Dirichlet pattern and free DOFs."""
    footing = (mesh.coords[:, 1] == cfg.size_xy) & (mesh.coords[:, 0] <= 1.0001)
    mesh.dirichlet = np.zeros((mesh.n_nodes, 2))
    mesh.dirichlet[footing, 1] = 1.0
    mesh.free = _free_mask(cfg, mesh.coords)
    return mesh


def build_mesh(cfg: FootingConfig) -> Mesh:
    """Footing mesh + BCs (`Plasticity2D_DP/pythonFEM.py:175-184`)."""
    return _with_bcs(cfg, square_mesh(cfg.level, cfg.etype, cfg.size_xy))


def tangent_mg_mesh(cfg: FootingConfig) -> Mesh:
    """The mesh a `tangent_mg` run solves on and returns: the level-1 mesh
    refined cfg.level - 1 times, in fine-RCM node order, with the BCs (the
    lattice and triangulation of `build_mesh(cfg)`, other numbers).  The
    hierarchy's fine level, without its operators."""
    base = square_mesh(1, cfg.etype, cfg.size_xy)
    chain = mg.refinement_chain(base.coords, base.elems, cfg.level - 1)
    coords, elems, _ = spmv.permute_mesh(chain[-1][0], chain[-1][1],
                                         mg.fine_rcm_orders(chain)[-1])
    return _with_bcs(cfg, Mesh(coords, elems, cfg.etype))


def _settings(cfg: FootingConfig) -> NewtonSettings:
    return NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=1,  # the reference starts its history at index 1 (P:1025)
        max_trips=cfg.max_trips,
    )


def _monitor_and_hook(cfg: FootingConfig, mesh: Mesh, geom: asm.Geometry, tdtype: torch.dtype):
    """The recorded pressure and the d_zeta doubling rule, in the dtype of
    `geom` (the state's, or the f32 heads in df32, as the JAX package
    records the f32 head of the df32 pressure)."""
    device = geom.B.device
    nmap = asm.node_gather_map(geom)
    footing = torch.as_tensor(mesh.dirichlet[:, 1] > 0, device=device)
    n_footing = int((mesh.dirichlet[:, 1] > 0).sum())
    # a tensor divisor: PyTorch on CUDA divides by a Python scalar through
    # its rounded reciprocal
    scale = torch.full((), n_footing * cfg.cohesion, dtype=geom.B.dtype, device=device)

    def monitor(u, s):
        # normalized mean footing pressure: -mean over the footing nodes of
        # the nodal projection of s_yy, / cohesion (P:1105-1107)
        p_node = asm.project_to_nodes(geom, s[1].to(geom.B.dtype), nmap)
        return -torch.where(footing, p_node, torch.zeros_like(p_node)).sum() / scale

    # the criterion is compared in the tangent dtype, against the
    # tolerance rounded the same way (solve/newton.py as_tdtype)
    tol = float(torch.tensor(cfg.newton_tol, dtype=tdtype))

    def accept_hook(pressure, pressure_old, crit):
        # double d_zeta while the pressure curve is still flat and Newton
        # converged tightly (P:1109-1110); the increment in the monitor's
        # dtype
        grow = float(pressure - pressure_old) < 0.1 and crit < tol
        return pressure, 2.0 if grow else 1.0

    return monitor, accept_hook


def solve(cfg: FootingConfig = FootingConfig(), device=None) -> FootingResult:
    """Run the footing benchmark: elastic predictor with the inhomogeneous
    Dirichlet load, then the adaptive load-stepped Newton.

    `device`: where to run (`utils.precision.resolve_device`).
    cfg.precision == "df32" runs `build_df32`.  In native float32 with the
    dense solver the elastic Cholesky factor is reused while no point is
    plastic (the JAX package enables the reuse for f32 only).
    """
    device = resolve_device(device)
    if cfg.precision == "df32":
        return _solve_df32(cfg, device)
    policy = dtype_policy(cfg.precision, cfg.dtype)
    dtype = policy.state
    mesh = build_mesh(cfg)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)

    fmap, n_free = asm.free_dof_map(mesh.free)
    free_idx = torch.as_tensor(np.nonzero(mesh.free.reshape(-1))[0], device=device)
    coords = torch.as_tensor(mesh.coords, dtype=dtype, device=device)
    geom = asm.compute_geometry(coords, mesh.elems, volume_element(cfg.etype))
    dirichlet = torch.as_tensor(mesh.dirichlet.reshape(-1), dtype=dtype, device=device)
    monitor, accept_hook = _monitor_and_hook(cfg, mesh, geom, policy.tangent)

    # elastic predictor with inhomogeneous Dirichlet (P:996-1004):
    # ud = -d_zeta * dirichlet; K u = -K ud on the free DOFs
    ud = -cfg.d_zeta * dirichlet
    D = elastic_tangent_lanes(shear, bulk, geom.n_int, dtype, device)
    f = -asm.tangent_matvec(geom, D, ud)
    cg_tol = plastic_cg_tol(cfg.cg_tol, dtype)
    plan = L = None
    if cfg.solver == "dense":
        plan = asm.dense_free_plan(geom, fmap, n_free)
        K_free = asm.assemble_dense_free(asm.element_stiffness(geom, D), plan)
        L = torch.linalg.cholesky(K_free)
        U_it0 = ud.clone()
        U_it0[free_idx] = torch.cholesky_solve(f[free_idx, None], L)[:, 0]
    else:
        # matrix-free predictor with the Dirichlet lift: U = ud + u, K u =
        # -K ud on the free DOFs (u zero on the constrained ones)
        free_mask = torch.as_tensor(mesh.free.reshape(-1), device=device)
        U_it0 = ud + solve_cg(
            lambda v: asm.tangent_matvec(geom, D, v), f, free_mask,
            precond=stiffness_block_jacobi(geom, D, free_mask), tol=cg_tol, maxiter=cfg.cg_maxiter,
            structure=cfg.cg_structure,
        ).x

    stepper = build_load_stepper(
        geom, free_idx, plan, shear, bulk, eta, c, _settings(cfg),
        monitor=monitor, accept_hook=accept_hook,
        apex_ep_uses_trial=cfg.bug_compatible_apex,
        dense_mode=cfg.dense_mode,
        elastic_factor=("cho", L) if dtype == torch.float32 and L is not None else None,
        solver=cfg.solver, cg_tol=cg_tol, cg_maxiter=cfg.cg_maxiter,
        cg_cap_relax=cfg.cg_cap_relax, cg_structure=cfg.cg_structure,
    )
    return _result(stepper(U_it0, 0.0, cfg.d_zeta), mesh)


def _assembled_setup(cfg: FootingConfig, mesh: Mesh, device: torch.device):
    """Host setup of `assembled_cg` (JAX `models/footing.py:266-292`): the
    RCM node order, elements sorted by their smallest node, the elastic
    CSR with unit-diagonal constrained rows (`apply_bc_csr` keeps the full
    element pattern, so every 2x2 node block is whole), on the device as
    f32 node blocks (K3's operator), and the refresh's destination table
    for every element, in the blocks' value positions.  Returns the
    permuted mesh, the operator, the table (rows of the runtime geometry's
    padding elements appended as -1 by the caller), and `new_of_old` and
    the element sort for `spmv.restore_reference_order`."""
    order = spmv.rcm_node_order(np.asarray(mesh.elems), mesh.n_nodes)
    coords2, elems2, new_of_old = spmv.permute_mesh(
        np.asarray(mesh.coords, np.float64), np.asarray(mesh.elems), order
    )
    esort = np.argsort(elems2.min(axis=1), kind="stable")
    elems2 = elems2[esort]
    free2 = np.asarray(mesh.free)[order]
    mesh2 = Mesh(coords2, elems2, cfg.etype, dirichlet=np.asarray(mesh.dirichlet)[order],
                 free=free2)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    K_csr = spmv.build_elastic_csr(coords2, elems2, volume_element(cfg.etype), shear, bulk,
                                   free=free2)
    corr = spmv.node_block_dest(spmv.element_corr_dest(K_csr, elems2, free2), K_csr, device)
    op = spmv.node_blocks(spmv.csr_to_device(K_csr, device, np.float32))
    return mesh2, op, corr, new_of_old, esort


def _tangent_mg_setup(cfg: FootingConfig, device: torch.device, extras: Optional[dict]):
    """Host setup of `tangent_mg` (JAX `models/footing.py:221-266`): the
    elastic hierarchy of the level-1 mesh refined cfg.level - 1 times
    (fine-RCM order, node blocks, f32 values on every level) and its
    tangent-refresh tables.  Returns (`tangent_mg_mesh`, checked against
    the hierarchy's fine level, the hierarchy, the tangent hierarchy);
    `extras`, if given, receives the host levels ("host_levels") and both
    hierarchies."""
    base = square_mesh(1, cfg.etype, cfg.size_xy)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    ref = volume_element(cfg.etype)
    hier, _, coarse = mg.build_hierarchy_ell(
        base.coords, base.elems, cfg.level - 1, functools.partial(_free_mask, cfg),
        shear, bulk, ref, device=device, fmt="slot", pack_bf16=False,
    )
    th = mg.build_tangent_hierarchy(hier, coarse, ref, device)
    fine = coarse["levels"][-1]
    mesh = tangent_mg_mesh(cfg)
    if not (np.array_equal(mesh.coords, fine["coords"])
            and np.array_equal(mesh.elems, np.asarray(fine["elems"]))):
        raise AssertionError("tangent_mg_mesh is not the hierarchy's fine level")
    if extras is not None:
        extras.update(host_levels=coarse["levels"], hierarchy=hier, tangent=th)
    return mesh, hier, th


def build_df32(cfg: FootingConfig, device=None, extras: Optional[dict] = None,
               shard_devices=None):
    """Build the df32 footing solver: returns (run, mesh).

    Host setup happens here: the mesh, the f64 geometry and its f32 heads,
    the dense assembly plan (dense solver) or, with `assembled_cg`, the RCM
    permutation, the f32 elastic operator in node blocks (K3's product),
    the refresh table and the f64 residual operators G/S (K1), or, with
    `tangent_mg`, the hierarchy, its refresh tables and G/S.  `run()`
    does the device work of one solve: the f32 elastic factors or the
    elastic preconditioner, the df32 elastic predictor (iterative
    refinement of an f32 inner solve, a Cholesky solve or PCG by
    block-Jacobi or the elastic V-cycle, against the f64 residual) and the
    load stepping; it returns the FootingResult on `mesh`: the reference
    mesh (with `assembled_cg` the solve runs on the RCM node order and
    sorted elements, and u and ep are moved back) or, with `tangent_mg`, the
    hierarchy's fine mesh (`tangent_mg_mesh`).  `run(resume=carry)` skips
    the predictor and continues from the carry (on the solver's node order:
    `FootingResult.carry`, or `utils.convert.load_checkpoint`).  `extras`,
    if given, receives the residual operators G/S ("residual_op"), with
    assembled_cg the elastic node blocks ("elastic_op") on the RCM-ordered
    mesh ("solver_mesh") and, with
    tangent_mg, the host levels and the hierarchies.

    `shard_devices` (inside a rank of `parallel.sharding.spawn`: the group
    size, or the rank's `ShardGroup`; JAX `models/footing.py:319-380`,
    `:612-640`): needs `tangent_mg`.  The hierarchy, the Galerkin value
    maps (the Mhat chain) and G/S are row-sharded over the ranks
    (`solve.multigrid.shard_hierarchy_ell`, `shard_tangent_hierarchy`,
    `ops.spmv.shard_rows`); the device is the rank's.
    """
    if cfg.precision != "df32":
        raise ValueError("build_df32 needs precision='df32'")
    group = None
    if shard_devices is not None:
        if not cfg.tangent_mg:
            raise ValueError("shard_devices requires tangent_mg")
        group = (shard_devices if isinstance(shard_devices, sharding.ShardGroup)
                 else sharding.current_group(shard_devices, device))
        device = group.device
    device = resolve_device(device)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    elastic_op = corr_dest = residual_op = hier = th = None
    if cfg.tangent_mg:
        mesh, hier, th = _tangent_mg_setup(cfg, device, extras)
        if group is not None:
            hier = mg.shard_hierarchy_ell(hier, group)
            th = mg.shard_tangent_hierarchy(th, hier, group)
    else:
        mesh = build_mesh(cfg)
    reference_mesh = mesh
    if cfg.assembled_cg:
        mesh, elastic_op, corr, new_of_old, esort = _assembled_setup(cfg, mesh, device)
    fmap, n_free = asm.free_dof_map(mesh.free)
    free_idx = torch.as_tensor(np.nonzero(mesh.free.reshape(-1))[0], device=device)
    free_mask = torch.as_tensor(mesh.free.reshape(-1), device=device)
    coords = torch.as_tensor(mesh.coords, dtype=torch.float64, device=device)
    geom = asm.compute_geometry(coords, mesh.elems, volume_element(cfg.etype))
    geom32 = geom.to(torch.float32)  # round-to-nearest heads, like gdf.hi
    n_dofs, n_int = 2 * geom.n_nodes, geom.n_int
    plan = asm.dense_free_plan(geom, fmap, n_free) if cfg.solver == "dense" else None
    if cfg.assembled_cg:
        # padding elements carry zero stiffness blocks: their rows are
        # dropped (-1)
        pad = corr.new_full((geom.n_elems - corr.shape[0],) + tuple(corr.shape[1:]), -1)
        corr_dest = torch.cat([corr, pad])
        elem_sort = (esort, int(geom.n_q), int(geom.n_real))
    if cfg.assembled_cg and extras is not None:
        extras.update(elastic_op=elastic_op, solver_mesh=mesh)
    if cfg.assembled_cg or cfg.tangent_mg:
        # residual_fmt "slot" and "rslot" (the JAX package's choice by n_q,
        # `models/footing.py:311-313`) are TPU tile layouts of one operator:
        # both are the port's CSR
        residual_op = spmv.residual_operators(geom, device)
        if group is not None:
            residual_op = tuple(spmv.shard_rows(A, group) for A in residual_op)
        if extras is not None:
            extras["residual_op"] = residual_op
    dirichlet = torch.as_tensor(mesh.dirichlet.reshape(-1), dtype=torch.float64, device=device)
    monitor, accept_hook = _monitor_and_hook(cfg, mesh, geom32, torch.float32)
    cg_tol = plastic_cg_tol(cfg.cg_tol, torch.float32)
    if residual_op is not None:
        apply_fn = lambda u: adf.elastic_apply_csr(*residual_op, u, shear, bulk)  # noqa: E731
    else:
        apply_fn = lambda u: adf.elastic_apply(geom, u, shear, bulk)  # noqa: E731

    def run(resume: Optional[dict] = None) -> FootingResult:
        # elastic predictor with inhomogeneous Dirichlet (P:996-1004): the
        # iterate starts at ud = -d_zeta * dirichlet, exact on the
        # constrained DOFs, and refinement drives K U -> 0 on the free ones
        ud = -cfg.d_zeta * dirichlet
        zero_f = torch.zeros(n_dofs, dtype=torch.float64, device=device)
        D = elastic_tangent_lanes(shear, bulk, n_int, torch.float32, device)
        Ki = None
        if cfg.solver == "dense":
            L, Ki = adf.dense_elastic_factors(geom32, D, plan)
            U_it0 = adf.refine_elastic_solve_df(L, free_idx, apply_fn, ud, zero_f)
        elif resume is not None:
            U_it0 = ud  # unused: the carry supplies the state
        else:
            if hier is not None:
                # the static elastic V-cycle on the fine elastic blocks
                pre = mg.make_vcycle_ell(hier)
                K_op = lambda v: spmv.sp_matvec(hier.levels[-1].op, v)  # noqa: E731
            else:
                pre = stiffness_block_jacobi(geom32, D, free_mask)
                if elastic_op is not None:
                    K_op = lambda v: spmv.sp_matvec(elastic_op, v)  # noqa: E731
                else:
                    K_op = lambda v: asm.tangent_matvec(geom32, D, v)  # noqa: E731
            U_it0 = adf.refine_elastic_solve_with(
                apply_fn,
                lambda r32: solve_cg(K_op, r32, free_mask, precond=pre, tol=cg_tol,
                                     maxiter=cfg.cg_maxiter, structure=cfg.cg_structure).x,
                ud, zero_f,
            )
        stepper = build_load_stepper(
            geom, free_idx, plan, shear, bulk, eta, c, _settings(cfg),
            monitor=monitor, accept_hook=accept_hook,
            apex_ep_uses_trial=cfg.bug_compatible_apex,
            precision="df32",
            elastic_factor=("inv", Ki) if Ki is not None else None,
            residual_op=residual_op,
            solver=cfg.solver, elastic_op=elastic_op, corr_dest=corr_dest,
            cg_tol=cg_tol, cg_maxiter=cfg.cg_maxiter, cg_eta0=cfg.cg_eta0,
            # capped solves of the tangent multigrid count as inexact
            # Newton steps by default (JAX `models/footing.py:572-578`)
            cg_cap_relax=(cfg.cg_cap_relax if cfg.cg_cap_relax is not None
                          else (1e-2 if cfg.tangent_mg else None)),
            tangent_mg=(None if th is None else functools.partial(
                mg.tangent_vcycle, th, hier, shear=shear, bulk=bulk)),
            cg_deflate=cfg.cg_deflate, newton_damping=cfg.newton_damping,
            cg_structure=cfg.cg_structure,
        )
        res = stepper(U_it0, 0.0, cfg.d_zeta, resume=resume)
        out = _result(res, reference_mesh)._replace(carry=carry_of(res))
        if elastic_op is None:
            return out
        u, ep = spmv.restore_reference_order(out.u, out.ep, new_of_old, elem_sort)
        return out._replace(u=u, ep=ep)

    return run, reference_mesh


def solve_sharded_rank(group: sharding.ShardGroup, cfg: FootingConfig) -> FootingResult:
    """Rank function of `solve_sharded`: `build_df32(cfg,
    shard_devices=group)` run once, its schedule held equal on every
    rank."""
    run, _ = build_df32(cfg, shard_devices=group)
    r = run()
    group.same("the schedule", (r.n_steps, r.newton_trips, r.n_cg_total, r.n_plastic))
    return r


def solve_sharded(cfg: FootingConfig, n_devices: int, device=None) -> FootingResult:
    """The tangent-multigrid footing over `n_devices` ranks
    (`parallel.sharding.spawn`; device None: the card, "cpu": CPU ranks):
    rank 0's FootingResult, bit for bit the single-device run's."""
    return sharding.spawn(solve_sharded_rank, n_devices, cfg, device=device)


def build_df32_chunked(cfg: FootingConfig, trips_per_chunk: int = 3, max_chunks: int = 2000,
                       device=None):
    """The df32 footing run in chunks of `trips_per_chunk` load trips (JAX
    `models/footing.py:682`): returns (execute, mesh).
    `execute(checkpoint_path=None)` drives `build_df32` of cfg with
    max_trips = trips_per_chunk through `solve.chunked.run_chunked` and
    returns the last chunk's FootingResult (counts and histories of the
    whole run, `*_trips` of the chunk); with a checkpoint path an
    interrupted run continues from the last chunk written.  The trajectory
    is the single run's, bit for bit."""
    run, mesh = build_df32(dataclasses.replace(cfg, max_trips=trips_per_chunk), device)

    def execute(checkpoint_path=None) -> FootingResult:
        return run_chunked(run, zeta_max=cfg.zeta_max,
                           d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
                           max_chunks=max_chunks, checkpoint_path=checkpoint_path)

    return execute, mesh


def _result(res: LoadSteppingResult, mesh: Mesh) -> FootingResult:
    """LoadSteppingResult -> FootingResult of float64 numpy arrays."""
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
        n_cg_total=int(res.n_cg_total),
        newton_trips=tuple(res.newton_trips),
        crit_trips=tuple(res.crit_trips),
        zeta_trips=tuple(res.zeta_trips),
        cg_trips=tuple(res.cg_trips),
    )


def _solve_df32(cfg: FootingConfig, device=None) -> FootingResult:
    """The df32 preset: f64 state and residual, f32 tangent solves."""
    run, _ = build_df32(cfg, device)
    return run()
