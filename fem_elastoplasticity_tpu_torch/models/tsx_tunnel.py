"""TSX tunnel excavation: Drucker-Prager elastoplasticity on the
experiment's unstructured triangle mesh (476 nodes, 887 P1 triangles),
with P1, P2 or P4 elements.

Port of `fem_elastoplasticity_tpu/models/tsx_tunnel.py`: `solve` runs the
native presets, f64 (parity) and f32 (`TsxTunnelConfig.fast_f32`, the
return map in kernel K2), on the dense solver or by block-Jacobi PCG
(`solver="cg"`), or, for `precision="df32"`, `build_df32`: the bench
preset on the dense solver; block-Jacobi PCG on the matrix-free tangent or,
with `assembled_cg`, on the assembled elastic operator (kernel K3's
product) plus the gathered plastic correction, the residual through K1; and
multigrid-preconditioned CG (`solver="ell"`): at P1 on refined meshes the
scale preset (`TsxTunnelConfig.fast_scale`) on assembled operators in node
layouts (K3 and K4, K5 on the levels of 500,000 rows or more, the residual
through K1; K6 for every operator with `spmv_fmt="ell"` and
`residual_fmt="ell"`), and at P2/P4 p-multigrid: the P1 hierarchy of the
high-order node lattice preconditions the high-order tangent, applied as
S (d (G v)) on the f32 heads of the residual operators (`gs_tangent`, K3's
CSR kernel) or matrix-free; and `solver="mg"` at P1, native or df32: CG
preconditioned by the matrix-free geometric multigrid V-cycle of the
refinement hierarchy with a dense Cholesky coarse solve.  Every route
takes `support_pressure` (a normal traction on the tunnel wall, ramped
with the load factor), the CG routes `cg_structure="scan"` and, in df32,
a recycled deflation basis (`cg_deflate`); `build_df32_chunked` runs a
df32 build in chunks of load trips with an optional checkpoint file.

Multi-device runs (`parallel/sharding.py`, ranks over torch.distributed):
`solve_sharded` and `solve_sharded_df32` shard the elements of the
matrix-free CG solve (nodal sums reduced in rank order), and
`solve_sharded_scale` (`build_df32(shard_devices=...)` inside a rank) the
rows of the scale preset's assembled operators; each returns rank 0's
result, and the ranks' schedules are held equal.
Anchors: 17 accepted load steps, 28
Newton iterations, u[40, 0] = -1.9794499636012143e-03; the f32 preset
reaches 17 steps and u[40, 0] within ~1e-5; the scale preset at refine
level 1 reaches 17 steps and u[40, 0] = -2.166787295662e-03; P4 (the
reference's own configuration, `tsx-tunnel/sandbox.py:4`) 17 steps, 40
Newton iterations, 79 plastic points, u[40, 0] = -2.267020043e-03.

The dense and matrix-free paths do not permute the mesh.  The assembled
paths compute on a locality ordering of nodes and elements and hand their
results back in the reference order.
"""
from __future__ import annotations

import dataclasses
import pathlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..mesh.boundary import boundary_edges
from ..mesh.midpoints import promote
from ..mesh.refine import refine_uniform
from ..mesh.structured import Mesh
from ..ops import assembly as asm
from ..ops import assembly_df as adf
from ..ops import spmv
from ..ops.elements import ElementType, surface_element, volume_element
from ..ops.spmv import sp_matvec
from ..parallel import sharding
from ..solve import multigrid as mgm
from ..solve.cg import plastic_cg_tol, solve_cg, stiffness_block_jacobi
from ..solve.chunked import run_chunked
from ..solve.newton import LoadSteppingResult, NewtonSettings, build_load_stepper
from ..utils.precision import dtype_policy, resolve_device
from .config import P_EXTRA, TsxTunnelConfig
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


def tunnel_wall_edges(mesh: Mesh) -> np.ndarray:
    """Boundary edges of the tunnel wall, the interior boundary: those whose
    end nodes lie strictly inside the +-50 box (JAX `models/tsx_tunnel.py
    :79`), with their higher-order nodes on P2/P4 meshes."""
    edges = boundary_edges(np.asarray(mesh.elems), mesh.etype)
    c = np.asarray(mesh.coords)
    inner = (np.abs(c[edges[:, 0]]) < 49.0).all(axis=1) & (
        np.abs(c[edges[:, 1]]) < 49.0).all(axis=1)
    return edges[inner]


def support_force(cfg: TsxTunnelConfig, mesh: Mesh, dtype: torch.dtype,
                  device) -> Optional[torch.Tensor]:
    """The support-pressure load direction f_ext (2 n_n,) of `mesh` in
    `dtype`: the normal traction cfg.support_pressure on the tunnel wall
    with the arc-length measure of its (curved) edges, which the stepper
    ramps with the load factor (JAX `:188-196` native, `:623-639` df32,
    there a DF pair of the f64 traction); None without a support
    pressure."""
    if cfg.support_pressure == 0.0:
        return None
    coords = torch.as_tensor(mesh.coords, dtype=dtype, device=device)
    return asm.pressure_traction_vector(coords, tunnel_wall_edges(mesh),
                                        surface_element(cfg.etype), cfg.support_pressure,
                                        mesh.n_nodes)


def _mg_preconditioner(cfg: TsxTunnelConfig, mesh: Mesh, dtype: torch.dtype, device):
    """solver="mg": the matrix-free V-cycle of the red-refinement hierarchy
    of the tsx mesh (JAX `:199-257` native, `:641-690` and `:760-777`
    df32), its levels' geometry, elastic tangent and smoother in `dtype`
    (the state's natively, f32 from f32 coordinates in df32, built once
    here), level 0 solved by the Cholesky factor of its dense free-DOF
    stiffness.  Checks that the fine level is `mesh`."""
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    np_dtype = np.float32 if dtype == torch.float32 else np.float64
    with np.load(_DATA) as raw:
        base_coords, base_elems = raw["coords"].astype(np_dtype), raw["elems"]
    hier = mgm.build_hierarchy(base_coords, base_elems, cfg.refine_levels, _free_of)
    if not (np.array_equal(hier[-1].elems, np.asarray(mesh.elems))
            and np.allclose(hier[-1].coords, mesh.coords, rtol=0, atol=1e-5)):
        raise AssertionError("the hierarchy's fine level is not the tsx mesh")
    levels = mgm.build_mg_levels(
        hier, volume_element(ElementType.P1),
        lambda g: elastic_tangent_lanes(shear, bulk, g.n_int, dtype, device), device)
    lev0 = levels[0]
    fmap0, n_free0 = asm.free_dof_map(hier[0].free)
    idx0 = torch.as_tensor(np.nonzero(hier[0].free.reshape(-1))[0], device=device)
    K0 = asm.assemble_dense_free(asm.element_stiffness(lev0.geom, lev0.d),
                                 asm.dense_free_plan(lev0.geom, fmap0, n_free0))
    L0 = torch.linalg.cholesky(K0)

    def coarse_solve(r: torch.Tensor) -> torch.Tensor:
        z = torch.zeros_like(r)
        z[idx0] = torch.cholesky_solve(r[idx0, None], L0)[:, 0]
        return z

    return mgm.make_vcycle(levels, coarse_solve, nu=cfg.mg_nu)


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
    plan: Optional[asm.DensePlan]  # the dense solver's only
    settings: NewtonSettings
    consts: tuple  # (shear, bulk, eta, c)
    s0: torch.Tensor  # (4,) in the state dtype
    e0: torch.Tensor  # (4,) in the state dtype


def _problem(cfg: TsxTunnelConfig, device: torch.device,
             dtype: torch.dtype = torch.float64, mesh: Optional[Mesh] = None,
             dense: Optional[bool] = None) -> _Problem:
    """Host setup shared by the presets: mesh, geometry, DOF maps.

    The geometry is computed from coordinates rounded to `dtype`, as the
    JAX package's native path does (`models/tsx_tunnel.py:160`); s0 and e0
    are rounded the same way.  `mesh`: a permuted mesh to set up instead of
    `tsx_mesh` (the assembled paths).  The dense assembly plan is built
    where `dense` says (None: for the dense solver only)."""
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
        mesh, geom, free_idx,
        (asm.dense_free_plan(geom, fmap, n_free)
         if (cfg.solver == "dense" if dense is None else dense) else None),
        settings, (shear, bulk, eta, c), as_t(s0), as_t(e0),
    )


def _monitor(node: int):
    dof = 2 * node  # u_x of the tunnel-wall node; a (B,) row of a (B, n) batch
    return lambda u, s: u[..., dof]


def _scatter_free(free_idx: torch.Tensor, x_free: torch.Tensor, n_dofs: int):
    out = x_free.new_zeros(n_dofs)
    out[free_idx] = x_free
    return out


def _permuted(cfg: TsxTunnelConfig, mesh_ref: Mesh, order: np.ndarray):
    """`mesh_ref` on the node order `order` (old id at each new position),
    its elements sorted by their smallest node: consecutive integration
    points then reference nearby nodes, which keeps the rows of G and S
    local.  Returns (mesh, new_of_old, esort)."""
    coords2, elems2, new_of_old = spmv.permute_mesh(
        np.asarray(mesh_ref.coords, np.float64), np.asarray(mesh_ref.elems), order
    )
    esort = np.argsort(elems2.min(axis=1), kind="stable")
    elems2 = elems2[esort]
    mesh = Mesh(coords2, elems2, cfg.etype, dirichlet=np.zeros_like(coords2),
                free=_free_of(coords2))
    return mesh, new_of_old, esort


def lattice_order(mesh: Mesh, fine_coords: np.ndarray) -> np.ndarray:
    """The node order that puts a high-order mesh on its P1 lattice: the
    mesh node at each position of `fine_coords` (the hierarchy's fine
    level), matched by coordinates (JAX `models/tsx_tunnel.py:417-430`).
    Raises unless the match is a bijection within 1e-9 of the scale."""
    from scipy.spatial import cKDTree

    fine_c = np.asarray(fine_coords, np.float64)
    if fine_c.shape[0] != mesh.n_nodes:
        raise ValueError(f"the lattice has {fine_c.shape[0]} nodes, the mesh {mesh.n_nodes}")
    dist, order = cKDTree(np.asarray(mesh.coords, np.float64)).query(fine_c)
    if dist.max() >= 1e-9 * np.abs(fine_c).max() or np.unique(order).size != mesh.n_nodes:
        raise ValueError("the mesh nodes do not match the lattice one to one")
    return order


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

    f0, D = _initial_force(p), elastic_tangent_lanes(shear, bulk, geom.n_int, dtype, device)
    f_ext = support_force(cfg, p.mesh, dtype, device)
    rhs0 = -f0 if f_ext is None else -f0 + f_ext
    L = mg_pre = None
    cg_tol = plastic_cg_tol(cfg.cg_tol, dtype)
    if cfg.solver == "dense":
        u_elast, L = _dense_predictor(p, rhs0, D)
    else:
        # matrix-free PCG predictor, block-Jacobi or the V-cycle (JAX
        # `:265-285`)
        free_mask = torch.as_tensor(p.mesh.free.reshape(-1), device=device)
        if cfg.solver == "mg":
            mg_pre = _mg_preconditioner(cfg, p.mesh, dtype, device)
        u_elast = solve_cg(
            lambda v: asm.tangent_matvec(geom, D, v), rhs0, free_mask,
            precond=mg_pre or stiffness_block_jacobi(geom, D, free_mask), tol=cg_tol,
            maxiter=cfg.cg_maxiter, structure=cfg.cg_structure,
        ).x
    stepper = build_load_stepper(
        geom, p.free_idx, p.plan, shear, bulk, eta, c, p.settings,
        e0_dir=p.e0, monitor=_monitor(cfg.monitor_node), dense_mode=cfg.dense_mode,
        elastic_factor=("cho", L) if dtype == torch.float32 and L is not None else None,
        accumulate_ep=not cfg.bug_compatible_ep_reset,
        solver=cfg.solver, cg_tol=cg_tol, cg_maxiter=cfg.cg_maxiter,
        mg_preconditioner=mg_pre, cg_structure=cfg.cg_structure, f_ext_dir=f_ext,
    )
    res = stepper(cfg.d_zeta * u_elast, 0.0, cfg.d_zeta)
    return _result(res, p.mesh)


def _initial_force(p: _Problem) -> torch.Tensor:
    """The initial-stress force F0 = B^T (w * s0[:3]) (T:1737) on the
    problem's geometry."""
    return asm.internal_force(p.geom, p.s0[:3, None].expand(3, p.geom.n_int))


def _dense_predictor(p: _Problem, rhs: torch.Tensor, D: torch.Tensor):
    """The native dense elastic predictor: (u_elast, L), L the Cholesky
    factor of the elastic K_free (tangent D) and u_elast = K^-1 rhs on
    the free DOFs (rhs = -F0, plus the support traction)."""
    K_free = asm.assemble_dense_free(asm.element_stiffness(p.geom, D), p.plan)
    L = torch.linalg.cholesky(K_free)
    u_elast = _scatter_free(
        p.free_idx, torch.cholesky_solve(rhs[p.free_idx, None], L)[:, 0], 2 * p.geom.n_nodes
    )
    return u_elast, L


def _df32_cg_predictor(cfg: TsxTunnelConfig, p: _Problem, free_mask: torch.Tensor,
                       rhs: torch.Tensor, apply_fn, elastic_op=None, pre=None) -> torch.Tensor:
    """The df32 CG routes' elastic predictor K u = rhs (-F0, plus the
    support traction): PCG on the f32 elastic operator (matrix-free, or
    `elastic_op`'s node blocks), preconditioned by block-Jacobi or `pre`,
    as the inner solve, refined against the f64 residual `apply_fn` (JAX
    `models/tsx_tunnel.py:796-822`)."""
    shear, bulk = p.consts[:2]
    geom32 = p.geom.to(torch.float32)
    D = elastic_tangent_lanes(shear, bulk, p.geom.n_int, torch.float32, free_mask.device)
    if pre is None:
        pre = stiffness_block_jacobi(geom32, D, free_mask)
    if elastic_op is not None:
        K_op = lambda v: sp_matvec(elastic_op, v)  # noqa: E731
    else:
        K_op = lambda v: asm.tangent_matvec(geom32, D, v)  # noqa: E731
    cg_tol = plastic_cg_tol(cfg.cg_tol, torch.float32)
    return adf.refine_elastic_solve_with(
        apply_fn,
        lambda r32: solve_cg(K_op, r32, free_mask, precond=pre, tol=cg_tol,
                             maxiter=cfg.cg_maxiter, structure=cfg.cg_structure).x,
        torch.zeros(2 * p.geom.n_nodes, dtype=torch.float64, device=free_mask.device), rhs,
        iters=cfg.predictor_ir_iters,
    )


def _build_df32_ell(cfg: TsxTunnelConfig, device: torch.device, extras: Optional[dict],
                    group=None):
    """`build_df32` for `solver="ell"`: the multigrid hierarchy of assembled
    elastic P1 operators, built on the host with a locality node ordering,
    and the whole problem permuted onto that ordering (coordinates,
    elements, free mask, monitor node), so that the V-cycle never permutes.

    At P2/P4 (p-multigrid, JAX `models/tsx_tunnel.py:382-453`) the
    hierarchy has `P_EXTRA` more levels: the high-order node lattice of a
    straight-edged mesh is its P1 lattice refined once (P2) or twice (P4),
    so the P1 operator on the same nodes preconditions the high-order
    tangent; the nodes are matched by coordinates (`lattice_order`).  The
    fine P1 operator is then the preconditioner's only: the tangent, the
    criterion and the predictor's operator stay high-order.

    `group` (a `parallel.sharding.ShardGroup`, P1 only): the hierarchy, with
    f32 values on every level, and G and S are row-sharded over the ranks
    (JAX `:518-560`, `:922-985`); the tangent refresh writes the rank's
    slice of the fine values."""
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    with np.load(_DATA) as raw:
        base_coords, base_elems = raw["coords"].astype(np.float64), raw["elems"]
    p1 = cfg.etype == ElementType.P1
    hier, perms, coarse = mgm.build_hierarchy_ell(
        base_coords, base_elems, cfg.refine_levels + P_EXTRA[cfg.etype], _free_of, shear, bulk,
        volume_element(ElementType.P1), device=device, fmt=cfg.spmv_fmt,
        # K5 has no split-z instance: sharded runs smooth every level in f32
        **({} if group is None else {"pack_bf16": False}),
    )
    if group is not None:
        hier = mgm.shard_hierarchy_ell(hier, group)
    mesh_ref = tsx_mesh(cfg.etype, cfg.refine_levels)
    order = (np.argsort(np.asarray(perms[-1]), kind="stable") if p1
             else lattice_order(mesh_ref, coarse["fine_coords"]))
    mesh, new_of_old, esort = _permuted(cfg, mesh_ref, order)
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
    residual_op = spmv.residual_operators(geom, device, _residual_fmt(cfg),
                                          cfg.ell_overflow_frac)
    if group is not None:
        residual_op = tuple(spmv.shard_rows(A, group) for A in residual_op)
    if extras is not None:
        extras["residual_op"] = residual_op
    fine = hier.levels[-1]
    corr_dest = None
    if cfg.corr_mode == "scatter":
        # the table indexes the exact CSR the fine node blocks were made
        # from, mapped to the blocks' value positions; its rows follow the
        # sorted element order of the run-time geometry (global positions:
        # on a row slice the stepper shifts them)
        dest = spmv.element_corr_dest(coarse["fine_K"], mesh.elems, coarse["fine_free"])
        corr_dest = spmv.node_block_dest(dest, coarse["fine_K"], device)
    free_mask = torch.as_tensor(mesh.free.reshape(-1), device=device)
    cg_tol = plastic_cg_tol(cfg.cg_tol, torch.float32)
    pre = mgm.make_vcycle_ell(hier, nu=cfg.mg_nu, cycle=cfg.mg_cycle)
    if p1:
        # the assembled fine operator: CG's, the criterion's, the predictor's
        elastic_op = fine.op
        K_op = lambda v: sp_matvec(fine.op, v)  # noqa: E731
    else:
        # the high-order elastic operator on the f32 heads of G and S (CSR:
        # K3's CSR kernel; ELL: K6)
        elastic_op = None
        G32, S32 = adf.f32_heads(*residual_op)
        K_op = lambda v: adf.elastic_apply_gs32(G32, S32, v, shear, bulk)  # noqa: E731
    f_ext = support_force(cfg, mesh, torch.float64, device)

    def run(resume: Optional[dict] = None) -> LoadSteppingResult:
        zero_u = torch.zeros(n_dofs, dtype=torch.float64, device=device)
        if resume is None:
            s0_field = p.s0[:3, None].expand(3, n_int)
            f0 = sp_matvec(residual_op[1], s0_field.reshape(-1))
            # elastic predictor K u = -F0 (+ f_ext): CG preconditioned by the
            # V-cycle as the f32 inner solve, refined against the f64 residual
            u_elast = adf.refine_elastic_solve_with(
                lambda u: adf.elastic_apply_csr(*residual_op, u, shear, bulk),
                lambda r32: solve_cg(K_op, r32, free_mask, precond=pre, tol=cg_tol,
                                     maxiter=cfg.cg_maxiter, structure=cfg.cg_structure).x,
                zero_u, -f0 if f_ext is None else -f0 + f_ext, iters=cfg.predictor_ir_iters,
            )
        else:
            u_elast = zero_u  # unused: the carry supplies the state
        stepper = build_load_stepper(
            geom, p.free_idx, None, shear, bulk, eta, c, p.settings,
            e0_dir=p.e0, monitor=_monitor(monitor_node),
            precision="df32",
            accumulate_ep=not cfg.bug_compatible_ep_reset,
            residual_op=residual_op,
            solver="mg", mg_preconditioner=pre, elastic_op=elastic_op,
            plastic_cap=plastic_cap if p1 else None, corr_dest=corr_dest,
            cg_tol=cg_tol, cg_maxiter=cfg.cg_maxiter, cg_eta0=cfg.cg_eta0,
            cg_cap_relax=cfg.cg_cap_relax,
            gs_tangent=(G32, S32) if cfg.gs_tangent_on else None,
            cg_structure=cfg.cg_structure, cg_deflate=cfg.cg_deflate, f_ext_dir=f_ext,
        )
        return stepper(u_elast * cfg.d_zeta, 0.0, cfg.d_zeta, resume=resume)

    return run, mesh


def _residual_fmt(cfg: TsxTunnelConfig) -> Optional[str]:
    """`spmv.residual_operators`' format: the JAX package's slot layouts
    ("slot", "rslot") are the port's CSR."""
    return "ell" if cfg.residual_fmt == "ell" else None


def _build_df32_cg(cfg: TsxTunnelConfig, device: torch.device, extras: Optional[dict]):
    """`build_df32` for `solver="cg"` (JAX `models/tsx_tunnel.py:454-481`,
    `:796-822`) and `solver="mg"`: block-Jacobi PCG tangent solves, the
    preconditioner rebuilt from the tangent every Newton iteration, or
    ("mg", JAX `:641-690`, `:760-777`) PCG on the matrix-free tangent
    preconditioned by the f32 V-cycle of the refinement hierarchy, built
    once here.  Matrix-free by default; with
    `assembled_cg`, for any element type, the problem moves onto an RCM
    node order with sorted elements, the elastic stiffness is assembled once
    on the host into f32 node blocks (K3's product: CG's operator, the
    criterion's, the predictor's), the tangent adds the gathered correction
    of the plastic slot set, and the residual runs on G and S (K1)."""
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    mesh = mesh_ref = tsx_mesh(cfg.etype, cfg.refine_levels)
    monitor_node = cfg.monitor_node
    elastic_op = residual_op = None
    if cfg.assembled_cg:
        order = spmv.rcm_node_order(np.asarray(mesh_ref.elems), mesh_ref.n_nodes)
        mesh, new_of_old, esort = _permuted(cfg, mesh_ref, order)
        monitor_node = int(new_of_old[cfg.monitor_node])
        K_csr = spmv.build_elastic_csr(mesh.coords, mesh.elems, volume_element(cfg.etype),
                                       shear, bulk, free=mesh.free)
        elastic_op = spmv.node_blocks(spmv.csr_to_device(K_csr, device, np.float32))
    p = _problem(cfg, device, mesh=mesh)
    shear, bulk, eta, c = p.consts
    geom = p.geom
    n_dofs, n_int = 2 * geom.n_nodes, geom.n_int
    if cfg.assembled_cg:
        residual_op = spmv.residual_operators(geom, device, _residual_fmt(cfg),
                                              cfg.ell_overflow_frac)
        if extras is not None:
            extras.update(ell_new_of_old=new_of_old, reference_mesh=mesh_ref,
                          elem_sort=(esort, int(geom.n_q), int(geom.n_real)),
                          monitor_node=monitor_node, elastic_op=elastic_op,
                          residual_op=residual_op)
    free_mask = torch.as_tensor(mesh.free.reshape(-1), device=device)
    cg_tol = plastic_cg_tol(cfg.cg_tol, torch.float32)
    if residual_op is not None:
        apply_fn = lambda u: adf.elastic_apply_csr(*residual_op, u, shear, bulk)  # noqa: E731
    else:
        apply_fn = lambda u: adf.elastic_apply(geom, u, shear, bulk)  # noqa: E731
    mg_pre = (_mg_preconditioner(cfg, mesh, torch.float32, device) if cfg.solver == "mg"
              else None)
    f_ext = support_force(cfg, mesh, torch.float64, device)

    def run(resume: Optional[dict] = None) -> LoadSteppingResult:
        if resume is None:
            if residual_op is not None:
                f0 = sp_matvec(residual_op[1], p.s0[:3, None].expand(3, n_int).reshape(-1))
            else:
                f0 = _initial_force(p)
            rhs = -f0 if f_ext is None else -f0 + f_ext
            u_elast = _df32_cg_predictor(cfg, p, free_mask, rhs, apply_fn, elastic_op, mg_pre)
        else:
            # unused: the carry supplies the state
            u_elast = torch.zeros(n_dofs, dtype=torch.float64, device=device)
        stepper = build_load_stepper(
            geom, p.free_idx, None, shear, bulk, eta, c, p.settings,
            e0_dir=p.e0, monitor=_monitor(monitor_node),
            precision="df32",
            accumulate_ep=not cfg.bug_compatible_ep_reset,
            residual_op=residual_op,
            solver=cfg.solver, mg_preconditioner=mg_pre, elastic_op=elastic_op,
            plastic_cap=min(n_int, max(1024, n_int // 64)),
            cg_tol=cg_tol, cg_maxiter=cfg.cg_maxiter, cg_eta0=cfg.cg_eta0,
            cg_cap_relax=cfg.cg_cap_relax, cg_structure=cfg.cg_structure,
            cg_deflate=cfg.cg_deflate, f_ext_dir=f_ext,
        )
        return stepper(u_elast * cfg.d_zeta, 0.0, cfg.d_zeta, resume=resume)

    return run, mesh


def build_df32(cfg: TsxTunnelConfig, device=None, extras: Optional[dict] = None,
               shard_devices=None):
    """Build the df32 solver: returns (run, mesh).

    Host setup happens here: the mesh, the f64 geometry, the dense
    assembly plan and, with `assembled_cg`, the f64 strain and force
    operators G/S that the Newton residual applies through kernel K1 (K6
    with `residual_fmt="ell"`).
    `run(resume=None)` does the device work of one solve: the initial-stress
    force, the f32 elastic K_free with its Cholesky factor and its
    Jacobi-scaled explicit inverse Ki, the elastic predictor (skipped on
    resume) and the load stepping.  `run(resume)` continues from a carry
    (`solve.newton.carry_of`, `utils.convert.carry_from_jax`) on the
    solver's node order.

    `solver="cg"` (`_build_df32_cg`): block-Jacobi PCG tangent solves,
    matrix-free or, with `assembled_cg`, on the elastic node blocks (K3)
    and the gathered plastic correction, on an RCM node order.
    `solver="mg"` (`_build_df32_cg`): PCG on the matrix-free tangent
    preconditioned by the f32 matrix-free V-cycle, in the reference order.
    `solver="ell"` (`_build_df32_ell`; `TsxTunnelConfig.fast_scale` at P1,
    p-multigrid at P2/P4): the setup also builds the
    multigrid hierarchy (in `cfg.spmv_fmt`, its levels of 500,000 rows or
    more packed to bf16 on the slot format) and, with corr_mode="scatter",
    the tangent refresh's table, and permutes the problem onto the
    hierarchy's fine ordering.  On both assembled routes
    `mesh` and the run's result are in the permuted ordering.  `extras`, if
    given, receives what `_df32_result` needs to restore the reference
    order: `ell_new_of_old`, `elem_sort`, `reference_mesh`, and beside them
    the permuted `monitor_node` and the residual operators `residual_op`
    (G, S); on the "ell" route the device `hierarchy` and the host data of
    its levels `host_levels` (`multigrid.build_hierarchy_ell`'s
    `coarse["levels"]`), on the assembled "cg" route the `elastic_op`.

    `shard_devices` (called inside a rank of `parallel.sharding.spawn`: the
    group size, or the rank's `ShardGroup`): the multi-device build of
    `solver="ell"` at P1 (JAX `:518-560`), its operators row-sharded, the
    levels all smoothed from f32 values (`_build_df32_ell`); the device is
    the rank's.
    """
    if cfg.precision != "df32":
        raise ValueError("build_df32 needs precision='df32'")
    if shard_devices is not None:
        if cfg.solver != "ell":
            raise ValueError(f"shard_devices requires solver='ell'; got {cfg.solver!r}")
        if cfg.etype != ElementType.P1:
            raise NotImplementedError("shard_devices: the row-sharded build is the P1 scale "
                                      "path; P2/P4 p-multigrid runs on one device")
        group = (shard_devices if isinstance(shard_devices, sharding.ShardGroup)
                 else sharding.current_group(shard_devices, device))
        return _build_df32_ell(cfg, group.device, extras, group)
    device = resolve_device(device)
    if cfg.solver == "ell":
        return _build_df32_ell(cfg, device, extras)
    if cfg.solver in ("cg", "mg"):
        return _build_df32_cg(cfg, device, extras)
    p = _problem(cfg, device)
    shear, bulk, eta, c = p.consts
    geom = p.geom
    geom32 = geom.to(torch.float32)  # round-to-nearest heads, like gdf.hi
    n_dofs, n_int = 2 * geom.n_nodes, geom.n_int
    residual_op = (
        spmv.residual_operators(geom, device, _residual_fmt(cfg), cfg.ell_overflow_frac)
        if cfg.assembled_cg else None
    )
    f_ext = support_force(cfg, p.mesh, torch.float64, device)

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
            u_elast = adf.refine_elastic_solve_df(
                L, p.free_idx, apply_fn, zero_u, -f0 if f_ext is None else -f0 + f_ext)
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
            residual_op=residual_op, f_ext_dir=f_ext,
        )
        return stepper(u_elast * cfg.d_zeta, 0.0, cfg.d_zeta, resume=resume)

    return run, p.mesh


def build_df32_chunked(cfg: TsxTunnelConfig, trips_per_chunk: int = 3, max_chunks: int = 200,
                       device=None):
    """A df32 build run in chunks of `trips_per_chunk` load trips (JAX
    `models/tsx_tunnel.py:1101`): returns (execute, mesh).

    `execute(checkpoint_path=None)` runs `build_df32` of cfg with max_trips
    = trips_per_chunk through `solve.chunked.run_chunked`, each chunk
    resumed from the carry of the one before, and returns the last chunk's
    LoadSteppingResult (on the build's node order; its counts and
    histories are the whole run's, its `*_trips` the chunk's).  With a
    checkpoint path each chunk's carry is written there, and a run that
    finds the file continues from it, in a new process too.  The trajectory
    is the single run's, bit for bit.  The JAX package's split predictor is
    a dispatch-size workaround of its device runtime and has no
    counterpart."""
    run, mesh = build_df32(dataclasses.replace(cfg, max_trips=trips_per_chunk), device)

    def execute(checkpoint_path=None) -> LoadSteppingResult:
        return run_chunked(run, zeta_max=cfg.zeta_max,
                           d_zeta_min=cfg.d_zeta * cfg.d_zeta_min_ratio,
                           max_chunks=max_chunks, checkpoint_path=checkpoint_path)

    return execute, mesh


def run_df32_chunked(cfg: TsxTunnelConfig, trips_per_chunk: int = 3, max_chunks: int = 200,
                     device=None):
    """`build_df32_chunked` run once: (LoadSteppingResult, mesh) (JAX
    `:1165`)."""
    execute, mesh = build_df32_chunked(cfg, trips_per_chunk, max_chunks, device)
    return execute(), mesh


def _schedule(res: LoadSteppingResult) -> tuple:
    """What every rank of a sharded run must have decided alike."""
    return (res.n_steps, res.newton_trips, res.n_cg_total, res.n_plastic)


def solve_sharded_rank(group: sharding.ShardGroup, cfg: TsxTunnelConfig) -> TsxResult:
    """Rank function of `solve_sharded`: this rank's element shard of the
    native matrix-free CG solve (JAX `models/tsx_tunnel.py:1248`).  The
    elastic predictor is the replicated dense solve of the whole mesh on
    the force of the shards (JAX `:1328`); the stepper reduces its nodal
    sums over the ranks.  Returns the TsxResult with the whole mesh's ep."""
    if cfg.precision != "native":
        raise ValueError("solve_sharded runs precision='native'; df32: solve_sharded_df32")
    if cfg.solver not in ("dense", "cg") or cfg.assembled_cg:
        raise NotImplementedError(f"solve_sharded runs matrix-free CG; got solver={cfg.solver!r}"
                                  f", assembled_cg={cfg.assembled_cg}")
    device = group.device
    dtype = dtype_policy(cfg.precision, cfg.dtype).state
    p = _problem(cfg, device, dtype, dense=True)
    shear, bulk, eta, c = p.consts
    coords = torch.as_tensor(p.mesh.coords, dtype=dtype, device=device)
    geom = sharding.sharded_geometry(coords, p.mesh.elems, volume_element(cfg.etype), group)
    f0 = asm.internal_force(geom, p.s0[:3, None].expand(3, geom.n_int), group)
    f_ext = support_force(cfg, p.mesh, dtype, device)
    u_elast, _ = _dense_predictor(
        p, -f0 if f_ext is None else -f0 + f_ext,
        elastic_tangent_lanes(shear, bulk, p.geom.n_int, dtype, device))
    stepper = build_load_stepper(
        geom, p.free_idx, None, shear, bulk, eta, c, p.settings,
        e0_dir=p.e0, monitor=_monitor(cfg.monitor_node),
        accumulate_ep=not cfg.bug_compatible_ep_reset, solver="cg",
        cg_tol=plastic_cg_tol(cfg.cg_tol, dtype), cg_maxiter=cfg.cg_maxiter,
        cg_structure=cfg.cg_structure, f_ext_dir=f_ext, group=group,
    )
    res = stepper(cfg.d_zeta * u_elast, 0.0, cfg.d_zeta)
    return _sharded_result(group, res, p, geom)


def _sharded_result(group, res: LoadSteppingResult, p: _Problem, geom) -> TsxResult:
    """The element-sharded run's TsxResult: the schedule held equal on every
    rank, ep gathered onto the whole mesh's points."""
    group.same("the schedule", _schedule(res))
    ep = sharding.gather_points(res.ep, geom.n_q * p.geom.n_real, p.geom.n_int, group)
    return _result(res._replace(ep=ep), p.mesh)


def solve_sharded(cfg: TsxTunnelConfig, n_devices: int, device=None) -> TsxResult:
    """Multi-device tsx solve: the elements sharded over `n_devices` ranks
    (`parallel.sharding.spawn`; device None: the card, "cpu": CPU ranks),
    the load-stepped Newton with matrix-free block-Jacobi CG on every rank,
    whatever cfg.solver says (the JAX package's `solve_sharded`); the only
    collectives are the nodal sums.  Its trajectory is
    `solve(solver="cg")`'s."""
    return sharding.spawn(solve_sharded_rank, n_devices, cfg, device=device)


def solve_sharded_df32_rank(group: sharding.ShardGroup, cfg: TsxTunnelConfig) -> TsxResult:
    """Rank function of `solve_sharded_df32` (JAX `:1362`): the df32
    matrix-free CG solve, elements sharded, the f64 residual's partial
    forces added in rank order; the predictor is the single-device one on
    the whole (replicated) geometry."""
    if cfg.precision != "df32" or cfg.solver != "cg" or cfg.assembled_cg:
        raise ValueError("solve_sharded_df32 runs precision='df32' with matrix-free "
                         f"solver='cg'; got {cfg.precision!r}, {cfg.solver!r}, "
                         f"assembled_cg={cfg.assembled_cg}")
    device = group.device
    p = _problem(cfg, device)
    shear, bulk, eta, c = p.consts
    coords = torch.as_tensor(p.mesh.coords, dtype=torch.float64, device=device)
    geom = sharding.sharded_geometry(coords, p.mesh.elems, volume_element(cfg.etype), group)
    free_mask = torch.as_tensor(p.mesh.free.reshape(-1), device=device)
    f_ext = support_force(cfg, p.mesh, torch.float64, device)
    f0 = _initial_force(p)
    u_elast = _df32_cg_predictor(
        cfg, p, free_mask, -f0 if f_ext is None else -f0 + f_ext,
        lambda u: adf.elastic_apply(p.geom, u, shear, bulk))
    stepper = build_load_stepper(
        geom, p.free_idx, None, shear, bulk, eta, c, p.settings,
        e0_dir=p.e0, monitor=_monitor(cfg.monitor_node), precision="df32",
        accumulate_ep=not cfg.bug_compatible_ep_reset, solver="cg",
        cg_tol=plastic_cg_tol(cfg.cg_tol, torch.float32), cg_maxiter=cfg.cg_maxiter,
        cg_eta0=cfg.cg_eta0, cg_cap_relax=cfg.cg_cap_relax, cg_structure=cfg.cg_structure,
        cg_deflate=cfg.cg_deflate, f_ext_dir=f_ext, group=group,
    )
    res = stepper(u_elast * cfg.d_zeta, 0.0, cfg.d_zeta)
    return _sharded_result(group, res, p, geom)


def solve_sharded_df32(cfg: Optional[TsxTunnelConfig], n_devices: int, device=None) -> TsxResult:
    """Multi-device df32 tsx solve (default `TsxTunnelConfig.fast(solver=
    "cg")`): elements sharded over `n_devices` ranks, as `solve_sharded`,
    with the df32 state; its trajectory is the single-device df32 CG
    solve's."""
    cfg = cfg if cfg is not None else TsxTunnelConfig.fast(solver="cg")
    return sharding.spawn(solve_sharded_df32_rank, n_devices, cfg, device=device)


def solve_sharded_scale_rank(group: sharding.ShardGroup, cfg: TsxTunnelConfig) -> TsxResult:
    """Rank function of `solve_sharded_scale`: `build_df32(cfg,
    shard_devices=group)` run once, its schedule held equal on every rank,
    the result in the reference order."""
    extras: dict = {}
    run, mesh = build_df32(cfg, group.device, extras, shard_devices=group)
    res = run()
    group.same("the schedule", _schedule(res))
    return _df32_result(res, mesh, extras)


def solve_sharded_scale(cfg: Optional[TsxTunnelConfig], n_devices: int,
                        device=None) -> TsxResult:
    """Multi-device scale solve (default `TsxTunnelConfig.fast_scale(1)`;
    JAX `:1223`): the assembled hierarchy, its transfers and G/S
    row-sharded over `n_devices` ranks; the trajectory is the single-device
    `build_df32` run's bit for bit."""
    cfg = cfg if cfg is not None else TsxTunnelConfig.fast_scale(1)
    return sharding.spawn(solve_sharded_scale_rank, n_devices, cfg, device=device)


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
    """Host conversion of a df32 LoadSteppingResult.  The dense and
    matrix-free paths have no permutation.  With the `extras` of an
    assembled build (`solver="ell"`, or "cg" with `assembled_cg`), the
    reference node order and the element-major integration-point order
    are restored, and the mesh is the reference mesh."""
    out = _result(res, mesh)
    if not extras or "ell_new_of_old" not in extras:
        return out
    u, ep = spmv.restore_reference_order(
        out.u, out.ep, extras["ell_new_of_old"], extras["elem_sort"])
    return out._replace(u=u, ep=ep, mesh=extras["reference_mesh"])
