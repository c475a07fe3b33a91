"""TSX tunnel excavation: Drucker-Prager elastoplasticity on the
experiment's unstructured triangle mesh (476 nodes, 887 P1 triangles).

Port of `fem_elastoplasticity_tpu/models/tsx_tunnel.py`: `solve` runs the
native presets, f64 (parity) and f32 (`TsxTunnelConfig.fast_f32`, the
return map in kernel K2), or, for `precision="df32"`, `build_df32`: the
bench preset on the dense solver, and on refined meshes the scale preset
(`TsxTunnelConfig.fast_scale`, `solver="ell"`), whose tangent solves are CG
preconditioned by a multigrid V-cycle on assembled operators in node
layouts (kernels K3 and K4, K5 on the levels of 500,000 rows or more, the
residual through K1; K6 for every operator with `spmv_fmt="ell"` and
`residual_fmt="ell"`).
Anchors: 17 accepted load steps, 28
Newton iterations, u[40, 0] = -1.9794499636012143e-03; the f32 preset
reaches 17 steps and u[40, 0] within ~1e-5; the scale preset at refine
level 1 reaches 17 steps and u[40, 0] = -2.166787295662e-03.

The dense path does not permute the mesh.  The scale path computes on a
locality ordering of nodes and elements and hands its results back in the
reference order.
"""
from __future__ import annotations

import pathlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..mesh.midpoints import promote
from ..mesh.refine import refine_uniform
from ..mesh.structured import Mesh
from ..ops import assembly as asm
from ..ops import assembly_df as adf
from ..ops import spmv
from ..ops.elements import ElementType, volume_element
from ..ops.spmv import sp_matvec
from ..solve import multigrid as mgm
from ..solve.cg import solve_cg
from ..solve.newton import LoadSteppingResult, NewtonSettings, build_load_stepper
from ..utils.precision import dtype_policy, resolve_device
from .config import TsxTunnelConfig
from .materials import drucker_prager_fit, elastic_tangent_lanes, lame_moduli

_DATA = pathlib.Path(__file__).parent.parent / "data" / "tsx_tunnel_mesh.npz"


class TsxResult(NamedTuple):
    """Solve result at the API edge: float64 numpy arrays."""

    u: np.ndarray  # (n_n, 2)
    ep: np.ndarray  # (4, n_int)
    zeta_hist: np.ndarray
    displ_hist: np.ndarray  # tunnel-wall u_x history (T:1813)
    n_steps: int
    n_newton_total: int
    n_plastic: int
    mesh: Mesh
    n_cg_total: int = 0


def tsx_mesh(etype: ElementType = ElementType.P1, refine_levels: int = 0) -> Mesh:
    """Load the TSX mesh, optionally refine (P1), then promote to `etype`.

    Dirichlet BCs: normal displacement clamped on the +-50 box, i.e. u_x
    fixed where |x| > 49.99 and u_y fixed where |y| > 49.99 (homogeneous).
    """
    with np.load(_DATA) as raw:
        coords, elems = raw["coords"].astype(np.float64), raw["elems"]
    for _ in range(refine_levels):
        coords, elems = refine_uniform(coords, elems)
    coords, elems = promote(etype, coords, elems)
    return Mesh(coords, elems, etype, dirichlet=np.zeros_like(coords), free=_free_of(coords))


def _free_of(coords: np.ndarray) -> np.ndarray:
    """(n_n, 2) bool mask of free DOFs from coordinates (`tsx_mesh`)."""
    free = np.ones((coords.shape[0], 2), dtype=bool)
    free[np.abs(coords[:, 0]) > 49.99, 0] = False
    free[np.abs(coords[:, 1]) > 49.99, 1] = False
    return free


def initial_state(cfg: TsxTunnelConfig):
    """Initial stress and the derived initial strain (inverse plane-strain
    Hooke), `tsx-tunnel/pythonFEM.py:1675-1681`."""
    s0 = np.asarray(cfg.init_stress, dtype=np.float64)
    tr = s0[0] + s0[1] + s0[3]
    nu, E = cfg.poisson, cfg.young
    e0 = (
        np.array(
            [
                -nu * tr + (1 + nu) * s0[0],
                -nu * tr + (1 + nu) * s0[1],
                0.0,
                -nu * tr + (1 + nu) * s0[3],
            ]
        )
        / E
    )
    return s0, e0


class _Problem(NamedTuple):
    mesh: Mesh
    geom: asm.Geometry  # in the state dtype
    free_idx: torch.Tensor
    plan: Optional[asm.DensePlan]  # None on the assembled (solver="ell") path
    settings: NewtonSettings
    consts: tuple  # (shear, bulk, eta, c)
    s0: torch.Tensor  # (4,) in the state dtype
    e0: torch.Tensor  # (4,) in the state dtype


def _problem(cfg: TsxTunnelConfig, device: torch.device,
             dtype: torch.dtype = torch.float64, mesh: Optional[Mesh] = None) -> _Problem:
    """Host setup shared by the presets: mesh, geometry, DOF maps.

    The geometry is computed from coordinates rounded to `dtype`, as the
    JAX package's native path does (`models/tsx_tunnel.py:160`); s0 and e0
    are rounded the same way.  `mesh`: a permuted mesh to set up instead of
    `tsx_mesh` (the assembled path, which needs no dense assembly plan)."""
    dense = mesh is None
    if mesh is None:
        mesh = tsx_mesh(cfg.etype, cfg.refine_levels)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    s0, e0 = initial_state(cfg)
    coords = torch.as_tensor(mesh.coords, dtype=dtype, device=device)
    geom = asm.compute_geometry(coords, mesh.elems, volume_element(cfg.etype))
    fmap, n_free = asm.free_dof_map(mesh.free)
    free_idx = torch.as_tensor(np.nonzero(mesh.free.reshape(-1))[0], device=device)
    settings = NewtonSettings(
        maxit=cfg.newton_maxit,
        newton_tol=cfg.newton_tol,
        accept_tol=cfg.accept_tol,
        d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
        zeta_max=cfg.zeta_max,
        max_steps=cfg.max_steps,
        step0=0,
        max_trips=cfg.max_trips,
    )
    as_t = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    return _Problem(
        mesh, geom, free_idx, asm.dense_free_plan(geom, fmap, n_free) if dense else None,
        settings, (shear, bulk, eta, c), as_t(s0), as_t(e0),
    )


def _monitor(node: int):
    dof = 2 * node  # u_x of the tunnel-wall node
    return lambda u, s: u[dof]


def _scatter_free(free_idx: torch.Tensor, x_free: torch.Tensor, n_dofs: int):
    out = x_free.new_zeros(n_dofs)
    out[free_idx] = x_free
    return out


def solve(cfg: TsxTunnelConfig = TsxTunnelConfig(), device=None) -> TsxResult:
    """Run the excavation: elastic predictor + load-stepped Newton.

    `device`: where to run (`utils.precision.resolve_device`).
    cfg.precision == "df32" runs the bench preset (`build_df32`); native
    runs in cfg.dtype, float32 with the return map in kernel K2 and the
    elastic Cholesky factor reused while no point is plastic (the JAX
    package enables the reuse for f32 only, `models/tsx_tunnel.py:29-41`).
    """
    device = resolve_device(device)
    if cfg.precision == "df32":
        return _solve_df32(cfg, device)
    dtype = dtype_policy(cfg.precision, cfg.dtype).state
    p = _problem(cfg, device, dtype)
    shear, bulk, eta, c = p.consts
    geom = p.geom
    n_dofs = 2 * geom.n_nodes

    # initial-stress force F0 = B^T (w * s0[:3])  (T:1737)
    f0 = asm.internal_force(geom, p.s0[:3, None].expand(3, geom.n_int))
    D = elastic_tangent_lanes(shear, bulk, geom.n_int, dtype, device)
    K_free = asm.assemble_dense_free(asm.element_stiffness(geom, D), p.plan)
    L = torch.linalg.cholesky(K_free)
    u_elast = _scatter_free(
        p.free_idx, torch.cholesky_solve(-f0[p.free_idx, None], L)[:, 0], n_dofs
    )
    stepper = build_load_stepper(
        geom, p.free_idx, p.plan, shear, bulk, eta, c, p.settings,
        e0_dir=p.e0, monitor=_monitor(cfg.monitor_node), dense_mode=cfg.dense_mode,
        elastic_factor=("cho", L) if dtype == torch.float32 else None,
        accumulate_ep=not cfg.bug_compatible_ep_reset,
    )
    res = stepper(cfg.d_zeta * u_elast, 0.0, cfg.d_zeta)
    return _result(res, p.mesh)


def _build_df32_ell(cfg: TsxTunnelConfig, device: torch.device, extras: Optional[dict]):
    """`build_df32` for `solver="ell"`: the multigrid hierarchy of assembled
    elastic operators, built on the host with a locality node ordering, and
    the whole problem permuted onto that ordering (coordinates, elements,
    free mask, monitor node), so that the V-cycle never permutes."""
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    with np.load(_DATA) as raw:
        base_coords, base_elems = raw["coords"].astype(np.float64), raw["elems"]
    hier, perms, coarse = mgm.build_hierarchy_ell(
        base_coords, base_elems, cfg.refine_levels, _free_of, shear, bulk,
        volume_element(cfg.etype), device=device, fmt=cfg.spmv_fmt,
    )
    mesh_ref = tsx_mesh(cfg.etype, cfg.refine_levels)
    order = np.argsort(np.asarray(perms[-1]), kind="stable")
    coords2, elems2, new_of_old = spmv.permute_mesh(
        np.asarray(mesh_ref.coords, np.float64), np.asarray(mesh_ref.elems), order
    )
    # node-locality element sort: consecutive integration points then
    # reference nearby nodes, which keeps the rows of G and S local
    esort = np.argsort(elems2.min(axis=1), kind="stable")
    elems2 = elems2[esort]
    mesh = Mesh(coords2, elems2, cfg.etype, dirichlet=np.zeros_like(coords2),
                free=_free_of(coords2))
    monitor_node = int(new_of_old[cfg.monitor_node])

    p = _problem(cfg, device, mesh=mesh)
    shear, bulk, eta, c = p.consts
    geom = p.geom
    n_dofs, n_int = 2 * geom.n_nodes, geom.n_int
    if extras is not None:
        # u_ref[old] = u_perm[new_of_old[old]]; sorted[k] = original[esort[k]]
        extras["ell_new_of_old"] = new_of_old
        extras["elem_sort"] = (esort, int(geom.n_q), int(geom.n_real))
        extras["reference_mesh"] = mesh_ref
        extras["monitor_node"] = monitor_node
        extras["hierarchy"] = hier
        # the host data of every level (f64 CSR operator K, transfer P,
        # free, inv): the device hierarchy keeps no CSR, so this is the CSR
        # reference of its node blocks and node transfers
        extras["host_levels"] = coarse["levels"]
    # static plastic-slot cap of the tangent correction (the JAX package's
    # formula, `models/tsx_tunnel.py:491`): observed plastic fractions are
    # under 1% (1,477 of 227,072 points at level 4); 1/64 with a floor of
    # 1024 leaves more than twice that (14,192 slots of the 908,288 points
    # of level 5)
    plastic_cap = min(n_int, max(1024, n_int // 64))
    residual_op = spmv.residual_operators(geom, device, cfg.residual_fmt, cfg.ell_overflow_frac)
    if extras is not None:
        extras["residual_op"] = residual_op
    fine = hier.levels[-1]
    corr_dest = None
    if cfg.corr_mode == "scatter":
        # the table indexes the exact CSR the fine node blocks were made
        # from, mapped to the blocks' value positions; its rows follow the
        # sorted element order of the run-time geometry
        dest = spmv.element_corr_dest(coarse["fine_K"], mesh.elems, coarse["fine_free"])
        corr_dest = spmv.node_block_dest(dest, coarse["fine_K"], device)
    free_mask = torch.as_tensor(mesh.free.reshape(-1), device=device)
    cg_tol = cfg.cg_tol if cfg.cg_tol is not None else 2e-7
    pre = mgm.make_vcycle_ell(hier, nu=cfg.mg_nu, cycle=cfg.mg_cycle)

    def run(resume: Optional[dict] = None) -> LoadSteppingResult:
        zero_u = torch.zeros(n_dofs, dtype=torch.float64, device=device)
        if resume is None:
            s0_field = p.s0[:3, None].expand(3, n_int)
            f0 = sp_matvec(residual_op[1], s0_field.reshape(-1))
            # elastic predictor K u = -F0: CG on the assembled fine operator
            # as the f32 inner solve, refined against the f64 residual
            u_elast = adf.refine_elastic_solve_with(
                lambda u: adf.elastic_apply_csr(*residual_op, u, shear, bulk),
                lambda r32: solve_cg(
                    lambda v: sp_matvec(fine.op, v), r32, free_mask, precond=pre,
                    tol=cg_tol, maxiter=cfg.cg_maxiter,
                ).x,
                zero_u, -f0, iters=cfg.predictor_ir_iters,
            )
        else:
            u_elast = zero_u  # unused: the carry supplies the state
        stepper = build_load_stepper(
            geom, p.free_idx, None, shear, bulk, eta, c, p.settings,
            e0_dir=p.e0, monitor=_monitor(monitor_node),
            precision="df32",
            accumulate_ep=not cfg.bug_compatible_ep_reset,
            residual_op=residual_op,
            solver="mg", mg_preconditioner=pre, elastic_op=fine.op,
            plastic_cap=plastic_cap, corr_dest=corr_dest,
            cg_tol=cg_tol, cg_maxiter=cfg.cg_maxiter, cg_eta0=cfg.cg_eta0,
            cg_cap_relax=cfg.cg_cap_relax,
        )
        return stepper(u_elast * cfg.d_zeta, 0.0, cfg.d_zeta, resume=resume)

    return run, mesh


def build_df32(cfg: TsxTunnelConfig, device=None, extras: Optional[dict] = None):
    """Build the df32 solver: returns (run, mesh).

    Host setup happens here: the mesh, the f64 geometry, the dense
    assembly plan and, with `assembled_cg`, the f64 strain and force
    operators G/S that the Newton residual applies through kernel K1 (K6
    with `residual_fmt="ell"`).
    `run(resume=None)` does the device work of one solve: the initial-stress
    force, the f32 elastic K_free with its Cholesky factor and its
    Jacobi-scaled explicit inverse Ki, the elastic predictor (skipped on
    resume) and the load stepping.  `run(resume)` continues from a carry
    (`solve.newton.carry_of`, `utils.convert.carry_from_jax`).

    `solver="ell"` (`TsxTunnelConfig.fast_scale`): the setup also builds the
    multigrid hierarchy (in `cfg.spmv_fmt`, its levels of 500,000 rows or
    more packed to bf16 on the slot format) and, with corr_mode="scatter",
    the tangent refresh's table, and permutes the problem onto the
    hierarchy's fine ordering, so
    `mesh` and the run's result are in that ordering.  `extras`, if given,
    receives what `_df32_result` needs to restore the reference order:
    `ell_new_of_old`, `elem_sort`, `reference_mesh`, and beside them the
    permuted `monitor_node`, the device `hierarchy`, the host data of its
    levels `host_levels` (`multigrid.build_hierarchy_ell`'s
    `coarse["levels"]`) and the residual operators `residual_op` (G, S).
    """
    if cfg.precision != "df32":
        raise ValueError("build_df32 needs precision='df32'")
    device = resolve_device(device)
    if cfg.solver == "ell":
        return _build_df32_ell(cfg, device, extras)
    p = _problem(cfg, device)
    shear, bulk, eta, c = p.consts
    geom = p.geom
    geom32 = geom.to(torch.float32)  # round-to-nearest heads, like gdf.hi
    n_dofs, n_int = 2 * geom.n_nodes, geom.n_int
    residual_op = (
        spmv.residual_operators(geom, device, cfg.residual_fmt, cfg.ell_overflow_frac)
        if cfg.assembled_cg else None
    )

    def run(resume: Optional[dict] = None) -> LoadSteppingResult:
        s0_field = p.s0[:3, None].expand(3, n_int)
        if residual_op is not None:
            f0 = sp_matvec(residual_op[1], s0_field.reshape(-1))
            apply_fn = lambda u: adf.elastic_apply_csr(*residual_op, u, shear, bulk)  # noqa: E731
        else:
            f0 = asm.internal_force(geom, s0_field)
            apply_fn = lambda u: adf.elastic_apply(geom, u, shear, bulk)  # noqa: E731

        # f32 elastic stiffness, its factor (predictor) and the explicit
        # inverse of its Jacobi-scaled form (elastic Newton iterations)
        D = elastic_tangent_lanes(shear, bulk, n_int, torch.float32, device)
        L, Ki = adf.dense_elastic_factors(geom32, D, p.plan)

        zero_u = torch.zeros(n_dofs, dtype=torch.float64, device=device)
        if resume is None:
            u_elast = adf.refine_elastic_solve_df(L, p.free_idx, apply_fn, zero_u, -f0)
        else:
            u_elast = zero_u  # unused: the carry supplies the state
        stepper = build_load_stepper(
            geom, p.free_idx, p.plan, shear, bulk, eta, c, p.settings,
            e0_dir=p.e0, monitor=_monitor(cfg.monitor_node),
            elastic_factor=("inv", Ki),
            # Woodbury plastic solves: the tsx plastic set is tiny (3 of
            # 896 points at level 0)
            smw_cap=64,
            precision="df32",
            accumulate_ep=not cfg.bug_compatible_ep_reset,
            residual_op=residual_op,
        )
        return stepper(u_elast * cfg.d_zeta, 0.0, cfg.d_zeta, resume=resume)

    return run, p.mesh


def _result(res: LoadSteppingResult, mesh: Mesh) -> TsxResult:
    """LoadSteppingResult -> TsxResult of float64 numpy arrays."""
    f64 = lambda t: t.detach().to("cpu", torch.float64).numpy()  # noqa: E731
    return TsxResult(
        u=f64(res.u).reshape(-1, 2),
        ep=f64(res.ep),
        zeta_hist=f64(res.zeta_hist),
        displ_hist=f64(res.monitor_hist),
        n_steps=int(res.n_steps),
        n_newton_total=int(res.n_newton_total),
        n_plastic=int(res.n_plastic),
        mesh=mesh,
        n_cg_total=int(res.n_cg_total),
    )


def _solve_df32(cfg: TsxTunnelConfig, device=None) -> TsxResult:
    """df32 presets: f64 state and residual, f32 tangent solves."""
    extras: dict = {}
    run, mesh = build_df32(cfg, device, extras=extras)
    return _df32_result(run(), mesh, extras)


def _df32_result(res: LoadSteppingResult, mesh: Mesh, extras: Optional[dict] = None) -> TsxResult:
    """Host conversion of a df32 LoadSteppingResult.  The dense path has no
    permutation.  With the `extras` of an assembled (`solver="ell"`) build,
    the reference node order and the element-major integration-point order
    are restored, and the mesh is the reference mesh."""
    out = _result(res, mesh)
    if not extras or "ell_new_of_old" not in extras:
        return out
    u, ep = spmv.restore_reference_order(
        out.u, out.ep, extras["ell_new_of_old"], extras["elem_sort"])
    return out._replace(u=u, ep=ep, mesh=extras["reference_mesh"])
