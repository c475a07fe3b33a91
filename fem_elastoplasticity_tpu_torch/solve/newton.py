"""Load-stepped semi-smooth Newton: a host loop over device tensors.

Port of `fem_elastoplasticity_tpu/solve/newton.py` for `solver="dense"`;
`solver="cg"` (inexact Newton: CG tangent solves preconditioned by the
tangent's 2x2 nodal diagonal blocks, rebuilt every Newton iteration, on the
matrix-free tangent, on the assembled elastic operator refreshed from
every integration point or with the gathered plastic correction, or, with
`tangent_mg`, preconditioned by a multigrid V-cycle whose every level is
refreshed from the tangent); and, with a multigrid preconditioner,
`solver="mg"` (CG on the assembled elastic operator with the plastic
correction, refreshed into its values or gathered, or, where no elastic
operator is given (p-multigrid), on the high-order tangent: matrix-free or
`gs_tangent`, S (d (G v)) on the f32 heads of the residual operators).
The CG solves can recycle a deflation basis (`cg_deflate`), carried across
Newton iterations and load steps and through the resume carry;
`newton_damping` backtracks a Newton step on the residual norm.
The JAX package runs the whole schedule as one jitted `while_loop`; here the
controller is Python, and each Newton iteration reads its criterion (and
the plastic count) back to the host.  The controller semantics are kept
exactly:

  * the iterate is updated before the tolerance test; a NaN criterion
    counts as a failure and keeps U_it; after a failure the criterion
    becomes NaN, so the step is rejected,
  * accept a step when the criterion < accept_tol; halve d_zeta on reject,
  * stop when zeta_old >= zeta_max (with a 1e-12 slack: 17*(1/17) rounds
    just below 1.0, and without the slack an 18th step fires) or when
    d_zeta < d_zeta_min,
  * warm start U_it = (U - U_old)*(d_zeta/d_zeta_old) + U between trips,
  * the history index is clamped to max_steps-1.

Precisions (`utils/precision.py`): "native" runs everything in the
geometry's dtype; "df32" keeps the state and the residual in f64 and runs
the tangent, its solves, dU and the criterion in f32, as the JAX package's
df32 mode does.  Native float32 runs the return map in kernel K2
(`ops/return_map.py`) and follows the JAX package's native loop in its
arithmetic: zeta, d_zeta and the stop thresholds are rounded to float32 at
every step.  In every precision the criterion's elastic stress is
2G (e - tr/3) + K tr and the warm start divides by d_zeta_old as a tensor,
as the JAX loop does.

Multi-device runs (`parallel/sharding.py`) take the same loop on every
rank.  With `group` the geometry is the rank's element shard: the nodal
partial sums are added over the ranks in rank order (the JAX package's
`axis_name` sites of its matrix-free CG: the residual, the criterion's
elastic force, the matrix-free tangent, the preconditioner's blocks and
the plastic count; its sharded solves run no dense solver).  A
row-sharded operator (`ops.spmv.RowShard`, the assembled routes) needs no
`group` here: its products gather inside `sp_matvec`, and the tangent
refresh writes the rank's slice of the values (global destinations
shifted by the slice's first block, the others dropped: the JAX package's
`corr_shard_axis`).

`build_ensemble_stepper` runs B materials over one geometry (the JAX
package's `vmap` of this stepper, `parallel/ensemble.py`): a sweep is one
Newton iteration of every member still running, batched, and each member
keeps the trajectory of its single solve.
"""
from __future__ import annotations

import collections
import math
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..models.materials import dp_return_map_lanes, elastic_tangent_lanes
from ..ops import assembly as asm
from ..ops.return_map import dp_return_map_newton, dp_return_map_newton_batched
from ..ops.spmv import (CsrMatrix, EllMatrix, NodeBlockMatrix, RowShard, block_values,
                        local_of, sp_matvec, with_block_values)
from .cg import block_jacobi_preconditioner, deflation_harvest, solve_cg, solve_cg_members


# Eisenstat-Walker forcing: the share of the last Newton criterion that the
# next tangent solve's CG tolerance takes (the JAX package's cg_eta_safety)
CG_ETA_SAFETY = 0.1


def _spd_solve(K: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Dense SPD solve via Cholesky.  An indefinite K gives NaN (the NaN
    guard then treats the iteration as divergence), not an exception."""
    L, info = torch.linalg.cholesky_ex(K)
    x = torch.cholesky_solve(b[:, None], L)[:, 0]
    return torch.where(info == 0, x, torch.full_like(x, math.nan))


def _spd_solve_mixed(K: torch.Tensor, b: torch.Tensor, ir_iters: int = 3) -> torch.Tensor:
    """f64-accurate SPD solve: f32 Cholesky of the Jacobi-scaled K plus
    `ir_iters` passes of iterative refinement in K's dtype."""
    d = torch.rsqrt(torch.diagonal(K))
    Ks = K * d[:, None] * d[None, :]
    L, info = torch.linalg.cholesky_ex(Ks.to(torch.float32))

    def apply_inv(r):
        y = torch.cholesky_solve((r * d).to(torch.float32)[:, None], L)[:, 0]
        return y.to(K.dtype) * d

    x = apply_inv(b)
    for _ in range(ir_iters):
        x = x + apply_inv(b - K @ x)
    return torch.where(info == 0, x, torch.full_like(x, math.nan))


def refreshed_values(values: torch.Tensor, corr: torch.Tensor, dest: torch.Tensor) -> torch.Tensor:
    """A copy of the flat `values` with `corr` added at the positions `dest`
    (a `corr`-shaped int64 table; `values.numel()` for a dropped entry,
    which lands on a slot past the values and is cut off again: it must not
    wrap round to the last entry).  Two blocks of neighbouring elements hit
    the same entry, and the accumulating index_put_ sorts the destinations
    and adds each entry's contributions in their given order, so the sum
    has a fixed order (an atomic scatter-add would not)."""
    vals = torch.cat([values, values.new_zeros(1)])
    vals.index_put_((dest.reshape(-1),), corr.reshape(-1).to(vals.dtype), accumulate=True)
    return vals[:values.numel()]


class LoadSteppingResult(NamedTuple):
    u: torch.Tensor  # (2*n_n,) converged displacement
    ep: torch.Tensor  # (4, n_int) plastic strain
    zeta_hist: torch.Tensor  # (max_steps,)
    monitor_hist: torch.Tensor  # (max_steps,)
    n_steps: int  # accepted steps
    n_newton_total: int  # total inner iterations
    zeta: float  # final accepted load factor
    d_zeta: float
    n_plastic: int  # integration points with nonzero plastic strain
    n_cg_total: int  # cumulative inner CG iterations (0 on dense paths)
    # carry tail for exact resume
    u_old: torch.Tensor
    u_it: torch.Tensor
    d_zeta_old: float
    aux: float
    newton_trips: tuple = ()  # Newton iterations of each load trip of this run
    crit_trips: tuple = ()  # the last Newton criterion of each trip (NaN: failed)
    zeta_trips: tuple = ()  # the accepted load factor after each trip
    cg_trips: tuple = ()  # the CG solves of each trip: ((iterations, converged), ...)
    # the recycled deflation basis (cg_deflate > 0): (n_dofs, k) f32 and
    # the next slot to overwrite
    defl_w: Optional[torch.Tensor] = None
    defl_ring: int = 0


class NewtonSettings(NamedTuple):
    maxit: int
    newton_tol: float
    accept_tol: float
    d_zeta_min: float
    zeta_max: float
    max_steps: int  # history length
    step0: int  # first history index written (footing: 1, tsx: 0)
    max_trips: int = 10000  # safety bound on the outer loop


CARRY_KEYS = (
    "u", "u_old", "u_it", "ep", "zeta_old", "d_zeta", "d_zeta_old", "step",
    "aux", "zeta_hist", "monitor_hist", "nits_total", "ncg_total",
    "defl_w", "defl_ring",
)


def carry_of(res: LoadSteppingResult) -> dict:
    """LoadSteppingResult -> the stepper's resume carry (`chunked.carry_of`),
    the deflation basis and ring included where the run had one."""
    carry = dict(
        u=res.u, u_old=res.u_old, u_it=res.u_it, ep=res.ep,
        zeta_old=res.zeta, d_zeta=res.d_zeta, d_zeta_old=res.d_zeta_old,
        step=res.n_steps, aux=res.aux, zeta_hist=res.zeta_hist,
        monitor_hist=res.monitor_hist, nits_total=res.n_newton_total,
        ncg_total=res.n_cg_total,
    )
    if res.defl_w is not None:
        carry.update(defl_w=res.defl_w, defl_ring=res.defl_ring)
    return carry


def build_load_stepper(
    geom: asm.Geometry,
    free_idx: torch.Tensor,
    plan: asm.DensePlan,
    shear: float,
    bulk: float,
    eta: float,
    c: float,
    settings: NewtonSettings,
    monitor: Callable,
    e0_dir: Optional[torch.Tensor] = None,
    dense_mode: str = "f64",
    elastic_factor=None,
    smw_cap: Optional[int] = None,
    precision: str = "native",
    accumulate_ep: bool = True,
    residual_op=None,
    apex_ep_uses_trial: bool = False,
    accept_hook: Optional[Callable] = None,
    solver: str = "dense",
    mg_preconditioner: Optional[Callable] = None,
    elastic_op=None,
    plastic_cap: Optional[int] = None,
    corr_dest: Optional[torch.Tensor] = None,
    cg_tol: float = 1e-10,
    cg_maxiter: int = 2000,
    cg_eta0: Optional[float] = None,
    cg_cap_relax: Optional[float] = None,
    tangent_mg: Optional[Callable] = None,
    cg_deflate: int = 0,
    newton_damping: int = 0,
    gs_tangent: Optional[tuple] = None,
    cg_structure: str = "while",
    f_ext_dir: Optional[torch.Tensor] = None,
    group=None,
):
    """Build the load-stepping solver (dense or CG tangent solves).

    Args:
      geom:     geometry in the state dtype (f64 for both presets).
      free_idx: (n_free,) indices of free DOFs in the flat DOF vector.
      plan:     `ops.assembly.dense_free_plan` for the tangent assembly.
      monitor:  (u, s) -> scalar tensor recorded per accepted step.
      e0_dir:   (4,) initial-strain direction; the return map sees
                e0 = zeta * e0_dir (tsx excavation).  None -> no e0.
      dense_mode: "f64" or "mixed" (f32 Cholesky + f64 refinement) for
                the fresh factorizations of the native preset.
      elastic_factor: None (factor the tangent every iteration),
                ("inv", Ki): the explicit inverse of the elastic K_free in
                the tangent dtype, or ("cho", L): its Cholesky factor.
                While no point is plastic the tangent equals the elastic
                stiffness bitwise and dU = Ki @ rhs, or the solve with L;
                otherwise (no Woodbury cap) the tangent is factored afresh.
      smw_cap:  with ("inv", Ki): plastic iterations solve by the Woodbury
                identity over the first `smw_cap` plastic points; more
                plastic points than that take a fresh factor.
      precision: "native" or "df32" (module docstring).
      accumulate_ep: accumulate plastic strain across accepted steps; False
                reproduces the tsx reference's per-step reset of Ep_old.
      residual_op: optional (G, S) pair of f64 operators (`ops.spmv`
                `CsrMatrix` or `EllMatrix`): strains and
                the internal force go through K1 (K6) instead of the
                matrix-free gather path.
      apex_ep_uses_trial: the reference's apex plastic strain from the
                trial strain (footing `bug_compatible_apex`).
      accept_hook: (monitor value, aux, criterion) -> (aux', factor),
                called on every accepted step; d_zeta is scaled by factor
                (the footing doubles it).  None keeps d_zeta.
      solver:   "dense"; "cg": the tangent solve is CG preconditioned by
                the block-Jacobi inverse of the tangent's nodal 2x2 blocks
                (`ops.assembly.node_block_diagonal`), on the matrix-free
                tangent (`elastic_op` None), on `elastic_op` refreshed
                through `corr_dest`, or on `elastic_op` plus the gathered
                correction of `plastic_cap` slots; or "mg": CG preconditioned
                by `mg_preconditioner`, on `elastic_op` with the plastic
                correction or, without `elastic_op` (p-multigrid: the
                preconditioner's fine operator is not the tangent's), on the
                matrix-free tangent or the `gs_tangent` one.
                `plan` is read by the dense solver only and may be None
                otherwise.
      mg_preconditioner: r -> z, `solve.multigrid.make_vcycle_ell`.
      elastic_op: the assembled elastic stiffness (f32) with
                unit-diagonal constrained rows, `ops.spmv.NodeBlockMatrix`
                (kernel K3's product) or `EllMatrix` (K6).  It applies the
                criterion norms,
                and with the plastic slot set's B_p^T (w delta) B_p blocks
                it is the tangent (exact: the tangent equals the elastic one
                off the plastic set).
      plastic_cap: static size of the plastic slot set; invalid slots carry
                zero blocks.  More plastic points than the cap degrade the
                tangent (extra Newton iterations), never the residual.
      corr_dest: (n_e, 2n_p, 2n_p) integer table, `ops.spmv.element_corr_dest`
                mapped through `ops.spmv.node_block_dest`: the position in
                the node-block `elastic_op.block_values` (flat) of each
                element-block entry, -1 where a DOF is constrained
                (dropped).  Given (the JAX package's corr_mode="scatter"),
                each Newton iteration scatters the blocks into a copy of the
                values; None (corr_mode="gather") applies them in every CG
                product, `ops.assembly.plastic_correction_apply`.
                With solver="cg" the table covers every element (padding
                rows -1), and each Newton iteration adds every element's
                tangent deviation K_e(d) - K_e(d_elastic) into the copy
                (the JAX package's corr_full).
      cg_tol, cg_maxiter: relative tolerance and cap of the tangent CG.  A
                capped, unconverged solve counts as divergence.
      cg_eta0:  Eisenstat-Walker forcing: the CG tolerance of a Newton
                iteration is clip(CG_ETA_SAFETY * crit_prev, cg_tol,
                cg_eta0), in f32; the first iteration uses cg_eta0.
      cg_cap_relax: accept a capped solve whose preconditioned residual
                fell by this factor.  None: strict cap-as-divergence.
      tangent_mg: with solver="cg" and no elastic_op: d -> (operator,
                preconditioner), `solve.multigrid.tangent_vcycle` bound to
                its hierarchies; called once a Newton iteration on the
                consistent tangent, its operator is CG's and its V-cycle
                CG's preconditioner.
      cg_deflate: size k of a recycled deflation basis of the CG solves
                (`solve.cg.solve_cg` deflate): every solve runs deflated PCG
                against the basis, and then its solution, and its final
                preconditioned residual if it did not converge, are
                orthonormalized into the ring (`deflation_harvest`).  The
                basis lives across Newton iterations and load steps (it
                advances on rejected steps too) and in the resume carry
                (`defl_w`, `defl_ring`).  0: off.
      newton_damping: residual-norm backtracking: the step s dU with s
                halved up to this many times while the free-DOF residual
                2-norm does not fall below the current one.  The criterion
                still measures the undamped dU.  0: the undamped iteration.
      gs_tangent: (G32, S32), the f32 heads of the `residual_op`
                (`ops.assembly_df.f32_heads`), with an iterative solver and
                no `elastic_op`: the tangent CG operator is S32 (d (G32 v))
                through K3's CSR kernel (K6 on ELL heads); the residual and
                the criterion keep G and S in f64 (JAX
                `solve/newton.py:740-761`, where an elastic operator would
                take the tangent first).
      cg_structure: the CG solves' loop, "while" or "scan"
                (`solve.cg.solve_cg`).
      f_ext_dir: optional (2*n_n,) external load direction in the state
                dtype, ramped with the load factor: the residual is
                F_int(u) - zeta f_ext_dir (the tsx support pressure; JAX
                `solve/newton.py:327-329`, `:402-421`).
      group:    a `parallel.sharding.ShardGroup` when geom is this rank's
                element shard (JAX `axis_name`): the nodal partial sums
                are reduced over the ranks (module docstring); plastic
                strain stays on the shard, nodal vectors are replicated.
                Matrix-free block-Jacobi CG only (solver="cg", without
                residual or elastic operators or tangent multigrid).

    Returns run(U_it0, aux0, d_zeta0, resume=None) -> LoadSteppingResult.
    """
    df_mode = precision == "df32"
    if precision not in ("native", "df32"):
        raise ValueError(f"precision {precision!r}")
    if elastic_factor is not None and not (
        isinstance(elastic_factor, tuple) and elastic_factor[0] in ("inv", "cho")
    ):
        raise NotImplementedError("elastic_factor must be None, ('inv', Ki) or ('cho', L)")
    if solver not in ("dense", "cg", "mg"):
        raise NotImplementedError(f"solver {solver!r}")
    if tangent_mg is not None and (solver != "cg" or elastic_op is not None):
        raise NotImplementedError("tangent_mg needs solver='cg' without elastic_op")
    if cg_deflate and solver == "dense":
        raise NotImplementedError("cg_deflate needs an iterative solver")
    if elastic_op is not None and plastic_cap is None and not (
            solver == "cg" and corr_dest is not None):
        raise NotImplementedError(
            "an iterative solve on elastic_op needs corr_dest (solver='cg': the full "
            "refresh) or plastic_cap (the plastic slot set)"
        )
    if corr_dest is not None and not isinstance(local_of(elastic_op), NodeBlockMatrix):
        raise NotImplementedError("the tangent refresh writes the values of f32 node blocks")
    if group is not None and (solver != "cg" or residual_op is not None or elastic_op is not None
                              or tangent_mg is not None):
        raise NotImplementedError("an element-sharded stepper runs matrix-free block-Jacobi CG, "
                                  "without residual or elastic operators or tangent multigrid")
    if solver == "mg" and mg_preconditioner is None:
        raise NotImplementedError("solver='mg' needs mg_preconditioner")
    if gs_tangent is not None and (
            elastic_op is not None or solver == "dense" or residual_op is None
            or not all(isinstance(A, (CsrMatrix, EllMatrix))
                       for A in (*residual_op, *gs_tangent))):
        raise ValueError("gs_tangent needs an iterative solver without elastic_op and CSR "
                         "or ELL residual operators")
    sdtype = geom.B.dtype
    geom_t = geom.to(torch.float32) if df_mode else geom
    tdtype = geom_t.B.dtype
    device = geom.B.device
    n_dofs = 2 * geom.n_nodes
    n_int = geom.n_int
    mixed = dense_mode == "mixed" and tdtype == torch.float64
    # native float32: the return map in K2 (the JAX package's rule for its
    # Pallas kernel, `newton.py:357`), zeta a float32 scalar, and the
    # criterion and warm start in the JAX native loop's arithmetic; f64 and
    # df32 keep their own
    native_f32 = tdtype == torch.float32 and not df_mode
    rnd = (lambda x: float(np.float32(x))) if native_f32 else (lambda x: x)
    three = torch.full((), 3.0, dtype=tdtype, device=device)

    def as_tdtype(x: float) -> float:
        # the JAX package compares its criterion in its own dtype against
        # weakly typed tolerances; round the tolerance the same way
        return float(torch.tensor(x, dtype=tdtype))

    newton_tol = as_tdtype(settings.newton_tol)
    accept_tol = as_tdtype(settings.accept_tol)

    def return_map(u, ep, zeta, apply=False):
        """-> (s, ds in the tangent dtype, ind_p, lam, ep')."""
        if residual_op is not None:
            e = sp_matvec(residual_op[0], u).reshape(3, n_int)
        else:
            e = asm.strains(geom, u)
        if native_f32:
            # one K2 launch writes s, the full tangent, the mask and ep
            return dp_return_map_newton(
                e, ep, shear, bulk, eta, c, e0_dir=e0_dir, zeta=zeta,
                apply_plastic_strain=apply, apex_ep_uses_trial=apex_ep_uses_trial,
            )
        e0 = None if e0_dir is None else e0_dir * zeta
        s, ds, ind_p, lam, ep_ = dp_return_map_lanes(
            e, ep, shear, bulk, eta, c, e0=e0, apply_plastic_strain=apply,
            apex_ep_uses_trial=apex_ep_uses_trial,
        )
        return s, ds.to(tdtype), ind_p, lam, ep_

    def residual_force(s, zeta):
        """Newton residual F_int - zeta f_ext, in the tangent dtype (df32:
        the f32 head of the f64 difference)."""
        if residual_op is not None:
            f = sp_matvec(residual_op[1], s[:3].reshape(-1))
        else:
            f = asm.internal_force(geom, s[:3], group)
        if f_ext_dir is not None:
            f = f - zeta * f_ext_dir
        return f.to(tdtype)

    def elastic_force(v):
        """K_el v with the stress formed as the JAX package's loop forms it
        in every precision (its df32 criterion runs on the f32 heads):
        2G (e - tr/3) + K tr, with a true division (a tensor divisor:
        PyTorch on CUDA divides by a Python scalar through its rounded
        reciprocal)."""
        e = asm.strains(geom_t, v)
        t = e[0] + e[1]
        s = torch.stack([
            2.0 * shear * (e[0] - t / three) + bulk * t,
            2.0 * shear * (e[1] - t / three) + bulk * t,
            shear * e[2],
        ])
        return asm.internal_force(geom_t, s, group)

    def criterion(dU, U_head):
        # q1 = |dU|_K, q2 = |U_it|_K, q3 = |U_it + dU|_K in the elastic
        # energy norm, q3^2 = q2^2 + 2 dU.K.U_it + q1^2
        if elastic_op is not None:
            # assembled elastic operator through K3's product or K6: its
            # constrained rows are unit-diagonal, but dU and U_it vanish there
            KdU = sp_matvec(elastic_op, dU)
            KU = sp_matvec(elastic_op, U_head)
        else:
            KdU = elastic_force(dU)
            KU = elastic_force(U_head)
        q1sq = dU @ KdU
        q2sq = U_head @ KU
        q3sq = torch.clamp(q2sq + 2.0 * (dU @ KU) + q1sq, min=0.0)
        return torch.sqrt(q1sq) / (torch.sqrt(q2sq) + torch.sqrt(q3sq))

    def fresh(d, rhs):
        K = asm.assemble_dense_free(asm.element_stiffness(geom_t, d), plan)
        return _spd_solve_mixed(K, rhs) if mixed else _spd_solve(K, rhs)

    def smw(Ki, d, ind_p, rhs):
        """Woodbury plastic solve K_t^{-1} r with K_t = K_e + U C U^T:
        Ki r - Ki U (I + C U^T Ki U)^{-1} C U^T Ki r, C supported on the
        plastic slot set (no C^{-1}, so singular corrections are fine)."""
        P = smw_cap
        d_el = elastic_tangent_lanes(shear, bulk, n_int, tdtype, device)
        idx_p, valid_p = asm.plastic_slots(ind_p, P)
        Bp, wdelta, edp = asm.plastic_correction_gather(geom_t, d - d_el, idx_p, valid_p)
        n_p2 = Bp.shape[1]
        cols = (
            torch.arange(3, device=device)[:, None, None] * P
            + torch.arange(P, device=device)[None, None, :]
        ).expand(3, n_p2, P)
        rows = edp[None].expand(3, n_p2, P)
        # each (row, col) pair occurs once: a plain index write, no atomics
        U = torch.zeros((n_dofs, 3 * P), dtype=tdtype, device=device)
        U[rows.reshape(-1), cols.reshape(-1)] = Bp.reshape(-1)
        Uf = U[free_idx]
        KiU = Ki @ Uf  # (n_free, 3P)
        M = Uf.T @ KiU  # (3P, 3P)
        CM = torch.einsum("abp,bpj->apj", wdelta, M.reshape(3, P, 3 * P))
        A = torch.eye(3 * P, dtype=tdtype, device=device) + CM.reshape(3 * P, 3 * P)
        z = Ki @ rhs
        t = Uf.T @ z
        Ct = torch.einsum("abp,bp->ap", wdelta, t.reshape(3, P)).reshape(-1)
        y = torch.linalg.solve(A, Ct)
        return z - KiU @ y

    free_mask = torch.zeros(n_dofs, dtype=torch.bool, device=device)
    free_mask[free_idx] = True
    if solver != "dense":
        d_el = elastic_tangent_lanes(shear, bulk, n_int, tdtype, device)
        if solver == "cg" and tangent_mg is None:
            slot_map = asm.node_slot_map(geom_t)
        if corr_dest is not None:
            # -1 (constrained) destinations, and on a row slice those of
            # the other ranks' blocks, go past the block values
            n_vals = block_values(elastic_op).numel()
            dest = corr_dest.to(torch.int64)
            if isinstance(elastic_op, RowShard):
                dest = torch.where(dest >= 0, dest - 4 * elastic_op.entry0, -1)
            dest_table = torch.where((dest >= 0) & (dest < n_vals), dest, n_vals)

    def refreshed(corr, dest):
        """The elastic node blocks (this rank's slice of them) with `corr`
        added at the block-value positions `dest` (`dest_table` rows),
        `refreshed_values`."""
        vals = refreshed_values(block_values(elastic_op).reshape(-1), corr, dest)
        return with_block_values(elastic_op, vals.reshape(-1, 4))

    def tangent_operator(d, ind_p):
        """v -> K_tangent v.  Without elastic_op: the matrix-free tangent,
        or with gs_tangent S32 (d (G32 v)).  solver="cg" with corr_dest:
        the elastic operator refreshed with every element's tangent
        deviation.  Otherwise the elastic operator and the plastic slot
        set's correction blocks, scattered into a copy of its values with
        `corr_dest` (solver="mg"), else added in every product (the
        gathered correction)."""
        if elastic_op is None:
            if gs_tangent is not None:
                G32, S32 = gs_tangent
                return lambda v: sp_matvec(S32, asm.apply_tangent(
                    d, sp_matvec(G32, v).reshape(3, n_int)).reshape(-1))
            return lambda v: asm.tangent_matvec(geom_t, d, v, group)
        if solver == "cg" and corr_dest is not None:
            # element_stiffness is (2n_p, 2n_p, n_e): transpose to corr_dest's
            # (n_e, row, col)
            corr = asm.element_stiffness(geom_t, d - d_el).permute(2, 0, 1)
            A_t = refreshed(corr, dest_table)
            return lambda v: sp_matvec(A_t, v)
        idx_p, valid_p = asm.plastic_slots(ind_p, plastic_cap)
        Bp, wdelta, edp = asm.plastic_correction_gather(geom_t, d - d_el, idx_p, valid_p)
        if corr_dest is None:
            return lambda v: sp_matvec(elastic_op, v) + asm.plastic_correction_apply(
                Bp, wdelta, edp, n_dofs, v)
        corr = torch.einsum("aip,abp,bjp->pij", Bp, wdelta, Bp)
        A_t = refreshed(corr, dest_table[idx_p // geom_t.n_q])
        return lambda v: sp_matvec(A_t, v)

    def cg_solve(d, f_int, ind_p, crit_prev, defl):
        """Inexact Newton step by preconditioned CG -> (dU, ok, its, defl):
        the multigrid V-cycle (solver="mg"), the tangent V-cycle refreshed
        from d (tangent_mg), or the block-Jacobi inverse of the tangent's
        nodal blocks, rebuilt from d ("cg"); defl, the deflation (W, ring)
        or None, after this solve's harvest."""
        tol = cg_tol
        if cg_eta0 is not None:
            # Eisenstat-Walker forcing in f32, as the JAX loop computes it;
            # an infinite criterion (first iteration) gives cg_eta0
            f32 = np.float32
            t = f32(crit_prev) * f32(CG_ETA_SAFETY)
            t = f32(cg_eta0) if np.isposinf(t) else np.nan_to_num(t)
            tol = float(np.clip(t, f32(cg_tol), f32(cg_eta0)))
        if tangent_mg is not None:
            op, pre = tangent_mg(d)
        elif solver == "cg":
            op = tangent_operator(d, ind_p)
            pre = block_jacobi_preconditioner(
                asm.node_block_diagonal(geom_t, d, slot_map, group), free_mask)
        else:
            op, pre = tangent_operator(d, ind_p), mg_preconditioner
        res = solve_cg(
            op, -f_int, free_mask, precond=pre, tol=tol, maxiter=cg_maxiter,
            structure=cg_structure, deflate=None if defl is None else defl[0],
        )
        if defl is not None:
            # the solution (small modes amplified) and, of a solve that did
            # not converge, the residual it left feed the next solves' basis
            defl = deflation_harvest(*defl, [res.x, res.z], gates=[None, not res.converged])
        ok = res.converged
        if not ok and cg_cap_relax is not None:
            ok = bool(res.rel_residual <= cg_cap_relax)  # False for NaN
        return res.x, ok, res.iters, defl

    def newton_solve(d, f_int, ind_p, n_plastic):
        """One Newton linear solve K_tangent dU = -F on the free DOFs."""
        rhs = -f_int[free_idx]
        if elastic_factor is None:
            dU_free = fresh(d, rhs)
        elif elastic_factor[0] == "cho":
            if n_plastic == 0:
                dU_free = torch.cholesky_solve(rhs[:, None], elastic_factor[1])[:, 0]
            else:
                dU_free = fresh(d, rhs)
        else:
            Ki = elastic_factor[1]
            if n_plastic == 0:
                dU_free = Ki @ rhs
            elif smw_cap is not None and n_plastic <= smw_cap:
                dU_free = smw(Ki, d, ind_p, rhs)
            else:
                dU_free = fresh(d, rhs)
        dU = torch.zeros((n_dofs,), dtype=tdtype, device=device)
        dU[free_idx] = dU_free
        return dU

    def residual_norm(f):
        return torch.linalg.vector_norm(torch.where(free_mask, f, torch.zeros_like(f)))

    def damped(U_it, dU, f_int, ep, zeta):
        """U_it + s dU, s halved up to newton_damping times while the
        free-DOF residual norm of the trial is not below the current one
        (`newton.py:840-876`).  A quirk kept for parity with the JAX
        package: if no halving lowers the norm, the smallest trial step is
        taken all the same, and the caller's criterion measures the
        undamped dU, not the step taken."""
        phi0 = residual_norm(f_int)
        s = torch.ones((), dtype=tdtype, device=device)

        def phi(s):
            return residual_norm(
                residual_force(return_map(U_it + (s * dU).to(sdtype), ep, zeta)[0], zeta))

        t, phi_s = 0, phi(s)
        while t < newton_damping and bool(phi_s >= phi0):  # False for NaN
            s = 0.5 * s
            phi_s = phi(s)
            t += 1
        return U_it + (s * dU).to(sdtype)

    def inner_newton(U_it, ep, zeta, defl):
        """Semi-smooth Newton at a fixed load factor -> (U, crit, nits,
        the CG solves ((iterations, converged), ...), defl)."""
        crit, it, fail, solves = math.inf, 0, False, []
        while not fail and crit >= newton_tol and it < settings.maxit:
            s, ds, ind_p, _, _ = return_map(U_it, ep, zeta)
            f_int = residual_force(s, zeta)
            if solver != "dense":
                dU, ok, cg_its, defl = cg_solve(ds, f_int, ind_p, crit, defl)
                solves.append((int(cg_its), bool(ok)))
            else:
                n_plastic = int(ind_p.sum())
                dU, ok = newton_solve(ds, f_int, ind_p, n_plastic), True
            if newton_damping and ok:
                U_new = damped(U_it, dU, f_int, ep, zeta)
            else:
                U_new = U_it + dU.to(sdtype)
            crit = float(criterion(dU, U_it.to(tdtype)))
            fail = math.isnan(crit) or not ok
            if not fail:
                U_it = U_new
            it += 1
        return U_it, (math.nan if fail else crit), it, tuple(solves), defl

    def run(U_it0: torch.Tensor, aux0: float, d_zeta0: float, resume: Optional[dict] = None):
        """Execute the load-stepping schedule.

        `resume`: optional carry (`carry_of`, `utils.convert.carry_from_jax`)
        with keys CARRY_KEYS to restart from; missing keys use fresh values.
        The deflation keys are read with cg_deflate > 0 and dropped
        otherwise; a carry without them starts from an empty basis.
        """
        zeros_h = torch.zeros((settings.max_steps,), dtype=sdtype, device=device)
        st = dict(
            u=torch.zeros_like(U_it0), u_old=-U_it0, u_it=U_it0,
            ep=torch.zeros((4, n_int), dtype=sdtype, device=device),
            zeta_old=0.0, d_zeta=rnd(float(d_zeta0)), d_zeta_old=rnd(float(d_zeta0)),
            step=settings.step0, aux=float(aux0),
            zeta_hist=zeros_h, monitor_hist=zeros_h.clone(),
            nits_total=0, ncg_total=0,
            defl_w=(torch.zeros((n_dofs, cg_deflate), dtype=tdtype, device=device)
                    if cg_deflate else None),
            defl_ring=0,
        )
        if resume is not None:
            unknown = set(resume) - set(CARRY_KEYS)
            if unknown:
                raise ValueError(f"unknown resume keys {sorted(unknown)}")
            for k, v in resume.items():
                if k.startswith("defl_") and not cg_deflate:
                    continue
                if k == "defl_w":
                    if tuple(v.shape) != (n_dofs, cg_deflate):
                        raise ValueError(f"resume defl_w has shape {tuple(v.shape)}, "
                                         f"expected {(n_dofs, cg_deflate)}")
                    v = torch.as_tensor(v).to(dtype=tdtype, device=device).clone()
                elif isinstance(v, torch.Tensor):
                    v = v.to(dtype=sdtype, device=device).clone()
                elif k in ("step", "nits_total", "ncg_total", "defl_ring"):
                    v = int(v)
                else:
                    v = float(v)
                st[k] = v
        U, U_old, U_it, ep = st["u"], st["u_old"], st["u_it"], st["ep"]
        zeta_old, d_zeta, d_zeta_old = st["zeta_old"], st["d_zeta"], st["d_zeta_old"]
        step, aux = st["step"], st["aux"]
        zeta_hist, mon_hist = st["zeta_hist"], st["monitor_hist"]
        nits_total, ncg_total = st["nits_total"], st["ncg_total"]
        defl = None if st["defl_w"] is None else (st["defl_w"], st["defl_ring"])

        # stop thresholds, rounded as the JAX package's weakly typed
        # Python floats are against its dtype scalars
        zeta_stop = rnd(settings.zeta_max - 1e-12)
        d_zeta_min = rnd(settings.d_zeta_min)
        trips, done, newton_trips, crit_trips, zeta_trips, cg_trips = 0, False, [], [], [], []
        while not done and trips < settings.max_trips:
            zeta = rnd(zeta_old + d_zeta)
            # the deflation basis advances on rejected steps too
            U_conv, crit, nits, solves, defl = inner_newton(U_it, ep, zeta, defl)
            if crit < accept_tol:  # False for NaN
                s_rm, _, _, _, ep_new = return_map(U_conv, ep, zeta, apply=accumulate_ep)
                idx = min(step, settings.max_steps - 1)
                zeta_hist[idx] = zeta
                m = monitor(U_conv, s_rm)
                mon_hist[idx] = m
                factor = 1.0
                if accept_hook is not None:
                    aux, factor = accept_hook(m, aux, crit)
                U_old, U = U, U_conv
                if accumulate_ep:
                    ep = ep_new
                zeta_old = zeta
                d_zeta_old = d_zeta
                d_zeta = d_zeta * factor
                step += 1
            else:
                d_zeta = d_zeta * 0.5
            # the divisor is a tensor, as in the JAX loop: PyTorch on CUDA
            # divides by a Python scalar through its rounded reciprocal
            dz_old = torch.full((), d_zeta_old, dtype=sdtype, device=device)
            if df_mode:
                ratio = torch.full((), d_zeta, dtype=sdtype, device=device) / dz_old
                U_it = (U - U_old) * ratio + U
                done = (zeta_old - settings.zeta_max) >= -1e-12 or d_zeta < settings.d_zeta_min
            else:
                U_it = d_zeta * (U - U_old) / dz_old + U
                done = zeta_old >= zeta_stop or d_zeta < d_zeta_min
            nits_total += nits
            ncg_total += sum(k for k, _ in solves)
            newton_trips.append(nits)
            crit_trips.append(crit)
            zeta_trips.append(zeta_old)
            cg_trips.append(solves)
            trips += 1

        n_plastic = (ep != 0.0).any(dim=0).sum()
        if group is not None:
            n_plastic = group.sum_ranks(n_plastic)
        n_plastic = int(n_plastic)
        return LoadSteppingResult(
            u=U, ep=ep, zeta_hist=zeta_hist, monitor_hist=mon_hist,
            n_steps=step, n_newton_total=nits_total, zeta=zeta_old,
            d_zeta=d_zeta, n_plastic=n_plastic, n_cg_total=ncg_total,
            u_old=U_old, u_it=U_it, d_zeta_old=d_zeta_old, aux=float(aux),
            newton_trips=tuple(newton_trips), crit_trips=tuple(crit_trips),
            zeta_trips=tuple(zeta_trips), cg_trips=tuple(cg_trips),
            defl_w=None if defl is None else defl[0], defl_ring=0 if defl is None else defl[1],
        )

    return run


# ---------------------------------------------------------------------------
# the member-batched controller of material ensembles
# ---------------------------------------------------------------------------
# per process: the ensemble runs' Newton sweeps and host reads, summed over
# runs ("runs", "sweeps", "host_reads"); `chip_smoke.py` reads them
ENSEMBLE_STATS: collections.Counter = collections.Counter()


class EnsembleSteppingResult(NamedTuple):
    """`build_ensemble_stepper`: device fields with a leading member axis,
    counts as host numpy arrays."""

    u: torch.Tensor  # (B, 2*n_n)
    ep: torch.Tensor  # (B, 4, n_int)
    zeta_hist: torch.Tensor  # (B, max_steps)
    monitor_hist: torch.Tensor  # (B, max_steps)
    n_steps: np.ndarray  # (B,) accepted steps
    n_newton_total: np.ndarray  # (B,)
    zeta: np.ndarray  # (B,) final accepted load factor
    n_plastic: np.ndarray  # (B,)
    n_cg_total: np.ndarray  # (B,) CG iterations (0 on the dense solver)
    newton_trips: tuple  # per member: the Newton iterations of each load trip
    crit_trips: tuple  # per member: the last Newton criterion of each trip (NaN: failed)
    sweeps: int  # Newton sweeps: one Newton iteration of every running member
    host_reads: int  # values read back to the host, all sweeps together


def build_ensemble_stepper(
    geom: asm.Geometry,
    free_idx: torch.Tensor,
    plan: Optional[asm.DensePlan],
    shear: float,
    bulk: float,
    etas: np.ndarray,
    cs: np.ndarray,
    settings: NewtonSettings,
    monitor: Callable,
    e0_dir: Optional[torch.Tensor] = None,
    elastic_factor=None,
    smw_cap: Optional[int] = None,
    precision: str = "native",
    accumulate_ep: bool = True,
    solver: str = "dense",
    cg_tol: float = 1e-10,
    cg_maxiter: int = 2000,
    cg_eta0: Optional[float] = None,
):
    """The load-stepping solver of B materials over one geometry.

    The JAX package gets its ensemble by `vmap` of `build_load_stepper`: a
    vmapped while-loop runs until every member is done, and a member whose
    own condition fails keeps its carry.  Here a host loop of sweeps gives
    each member exactly the trajectory of its own single solve (its zeta,
    d_zeta, halving and stop, NaN guard, warm start and Newton count, the
    rules of `build_load_stepper`).  A sweep is one Newton iteration of
    every member still running, batched over them.  A member whose Newton
    loop ends in that sweep (converged, maxit, or a NaN / failed solve)
    takes its accept or reject and its controller update in the same sweep,
    with the others that end there, and starts its next load trip in the
    next.  The number of sweeps is the largest member Newton total.  Members
    never interact, so a member's result does not depend on this schedule,
    and a member that has stopped keeps its state bit for bit.  Batched
    products may round a member's values in other last bits than its
    single solve's (on the card and in the batch's matrix products).

    Per member, zeta, d_zeta, d_zeta_old and the step live on the host as
    float64 numpy arrays (native float32 rounds them through float32 as the
    single stepper does); each sweep copies every running member's (eta, c,
    zeta) to the card once, without a sync, where the return map and
    e0 = zeta e0_dir read them.  A sweep reads back one (B,) vector: the
    criterion, with the solve's convergence flag and CG count where there
    is a CG solve.  The dense float32 path reads a (B,) plastic flag
    before its solve too (the plastic members are factored afresh, the
    elastic ones reuse the shared factor), and each batched CG iteration
    reads whether any member runs.

    Args (as `build_load_stepper` unless said):
      etas, cs: (B,) float64 Drucker-Prager parameters of the members.
      monitor:  (U (B, 2*n_n), s) -> (B,) recorded per accepted step.
      elastic_factor: None (every member's tangent factored afresh every
                iteration: native f64), ("cho", L): the shared elastic
                Cholesky factor, reused by members with no plastic point
                (native f32), or ("inv", Ki) with `smw_cap`: the shared
                explicit elastic inverse and Woodbury solves over
                `smw_cap` plastic slots for every member, with no fresh
                factor past the cap (df32, the JAX ensemble's
                smw_fallback=False).
      solver:   "dense" or "cg" (block-Jacobi PCG on the matrix-free
                tangent, `solve.cg.solve_cg_members`).
      cg_eta0:  each member's Eisenstat-Walker forcing from its own last
                criterion.

    Returns run(U_it0 (2*n_n,), d_zeta0) -> EnsembleSteppingResult; U_it0
    is the shared elastic predictor scaled by d_zeta0.
    """
    df_mode = precision == "df32"
    if precision not in ("native", "df32"):
        raise ValueError(f"precision {precision!r}")
    if solver not in ("dense", "cg"):
        raise NotImplementedError(f"ensemble solver {solver!r}")
    if elastic_factor is not None and elastic_factor[0] not in ("inv", "cho"):
        raise NotImplementedError("elastic_factor must be None, ('inv', Ki) or ('cho', L)")
    if elastic_factor is not None and elastic_factor[0] == "inv" and smw_cap is None:
        raise NotImplementedError("the ensemble's ('inv', Ki) needs smw_cap")
    etas = np.asarray(etas, np.float64)
    cs = np.asarray(cs, np.float64)
    n_b = etas.shape[0]
    sdtype = geom.B.dtype
    geom_t = geom.to(torch.float32) if df_mode else geom
    tdtype = geom_t.B.dtype
    device = geom.B.device
    n_dofs, n_int = 2 * geom.n_nodes, geom.n_int
    native_f32 = tdtype == torch.float32 and not df_mode
    f32 = np.float32
    rnd = (lambda x: np.asarray(x, f32).astype(np.float64)) if native_f32 else (lambda x: x)
    three = torch.full((), 3.0, dtype=tdtype, device=device)
    as_t = lambda x: float(torch.tensor(x, dtype=tdtype))  # noqa: E731
    newton_tol, accept_tol = as_t(settings.newton_tol), as_t(settings.accept_tol)
    free_mask = torch.zeros(n_dofs, dtype=torch.bool, device=device)
    free_mask[free_idx] = True
    d_el = elastic_tangent_lanes(shear, bulk, n_int, tdtype, device)
    slot_map = asm.node_slot_map(geom_t) if solver == "cg" else None
    pinned = device.type == "cuda"

    def to_dev(x: np.ndarray, dtype=None) -> torch.Tensor:
        """A host array on the card, copied without a sync."""
        t = torch.as_tensor(np.ascontiguousarray(x), dtype=dtype)
        if pinned:
            return t.pin_memory().to(device, non_blocking=True)
        return t

    def return_map(u, ep, params, apply=False):
        """-> (s, ds in the tangent dtype, ind_p, lam, ep') of the members
        whose (eta, c, zeta) are the rows of params."""
        e = asm.strains(geom, u)
        if native_f32:
            return dp_return_map_newton_batched(e, ep, shear, bulk, params, e0_dir, apply)
        eta, c = params[:, 0:1].to(sdtype), params[:, 1:2].to(sdtype)
        e0 = None
        if e0_dir is not None:
            e0 = (e0_dir[None, :] * params[:, 2:3].to(e0_dir.dtype))[..., None]
        s, ds, ind_p, lam, ep_ = dp_return_map_lanes(
            e, ep, shear, bulk, eta, c, e0=e0, apply_plastic_strain=apply)
        return s, ds.to(tdtype), ind_p, lam, ep_

    def residual_force(s):
        return asm.internal_force(geom, s[:, :3]).to(tdtype)

    def elastic_force(v):
        """`build_load_stepper`'s elastic_force, member by member."""
        e = asm.strains(geom_t, v)
        t = e[:, 0] + e[:, 1]
        s = torch.stack([
            2.0 * shear * (e[:, 0] - t / three) + bulk * t,
            2.0 * shear * (e[:, 1] - t / three) + bulk * t,
            shear * e[:, 2],
        ], dim=1)
        return asm.internal_force(geom_t, s)

    def criterion(dU, U_head):
        dot = lambda a, b: (a * b).sum(dim=-1)  # noqa: E731
        KdU, KU = elastic_force(dU), elastic_force(U_head)
        q1sq, q2sq = dot(dU, KdU), dot(U_head, KU)
        q3sq = torch.clamp(q2sq + 2.0 * dot(dU, KU) + q1sq, min=0.0)
        return torch.sqrt(q1sq) / (torch.sqrt(q2sq) + torch.sqrt(q3sq))

    def fresh(d, rhs):
        """Each member's tangent assembled and factored: (Bp, n_free)."""
        K = asm.assemble_dense_free(asm.element_stiffness(geom_t, d), plan)
        L, info = torch.linalg.cholesky_ex(K)
        x = torch.cholesky_solve(rhs[..., None], L)[..., 0]
        return torch.where((info == 0)[:, None], x, torch.full_like(x, math.nan))

    def smw(Ki, d, ind_p, rhs):
        """`build_load_stepper`'s Woodbury solve for every member: the
        shared Ki r of all members as one (n_free x B) product, the
        capacitance systems as one batched (B, 3P, 3P) solve.  A member with
        no plastic point has zero corrections, y = 0 and dU = Ki r."""
        P, n_a = smw_cap, d.shape[0]
        idx_p, valid_p = asm.plastic_slots(ind_p, P)
        Bp, wdelta, edp = asm.plastic_correction_gather(geom_t, d - d_el, idx_p, valid_p)
        n_p2 = Bp.shape[2]
        cols = (torch.arange(3, device=device)[:, None, None] * P
                + torch.arange(P, device=device)[None, None, :]).expand(n_a, 3, n_p2, P)
        rows = edp[:, None].expand(n_a, 3, n_p2, P)
        mem = torch.arange(n_a, device=device)[:, None, None, None].expand(n_a, 3, n_p2, P)
        # each (member, row, col) occurs once: a plain index write
        U = torch.zeros((n_a, n_dofs, 3 * P), dtype=tdtype, device=device)
        U[mem.reshape(-1), rows.reshape(-1), cols.reshape(-1)] = Bp.reshape(-1)
        Uf = U[:, free_idx]
        KiU = Ki @ Uf  # (B, n_free, 3P)
        M = Uf.transpose(1, 2) @ KiU
        CM = torch.einsum("zabp,zbpj->zapj", wdelta, M.reshape(n_a, 3, P, 3 * P))
        A = torch.eye(3 * P, dtype=tdtype, device=device) + CM.reshape(n_a, 3 * P, 3 * P)
        Z = (Ki @ rhs.T).T
        t = (Uf.transpose(1, 2) @ Z[..., None])[..., 0]
        Ct = torch.einsum("zabp,zbp->zap", wdelta, t.reshape(n_a, 3, P)).reshape(n_a, -1)
        y = torch.linalg.solve(A, Ct)
        return Z - (KiU @ y[..., None])[..., 0]

    def dense_solve(d, f_int, ind_p):
        """Newton steps of the members: (dU (Ba, n_dofs), host reads)."""
        rhs = -f_int[:, free_idx]
        reads = 0
        if elastic_factor is None:
            dU_free = fresh(d, rhs)
        elif elastic_factor[0] == "inv":
            dU_free = smw(elastic_factor[1], d, ind_p, rhs)
        else:
            plastic = ind_p.any(dim=1).cpu().numpy()
            reads = 1
            dU_free = torch.empty_like(rhs)
            el, pl = np.nonzero(~plastic)[0], np.nonzero(plastic)[0]
            if el.size:
                e_idx = to_dev(el)
                dU_free[e_idx] = torch.cholesky_solve(
                    rhs[e_idx].T.contiguous(), elastic_factor[1]).T
            if pl.size:
                p_idx = to_dev(pl)
                dU_free[p_idx] = fresh(d[p_idx], rhs[p_idx])
        dU = torch.zeros((d.shape[0], n_dofs), dtype=tdtype, device=device)
        dU[:, free_idx] = dU_free
        return dU, reads

    def cg_tolerances(crit_prev: np.ndarray) -> np.ndarray:
        """Each member's CG tolerance: `build_load_stepper`'s forcing, in
        float32, from its own last criterion."""
        if cg_eta0 is None:
            return np.full(crit_prev.shape, cg_tol)
        t = crit_prev.astype(f32) * f32(CG_ETA_SAFETY)
        t = np.where(np.isposinf(t), f32(cg_eta0), np.nan_to_num(t))
        return np.clip(t, f32(cg_tol), f32(cg_eta0)).astype(np.float64)

    def run(U_it0: torch.Tensor, d_zeta0: float) -> EnsembleSteppingResult:
        U_it = U_it0.to(sdtype).expand(n_b, n_dofs).clone()
        U = torch.zeros_like(U_it)
        U_old = -U_it
        ep = torch.zeros((n_b, 4, n_int), dtype=sdtype, device=device)
        zeta_hist = torch.zeros((n_b, settings.max_steps), dtype=sdtype, device=device)
        mon_hist = torch.zeros_like(zeta_hist)
        zeta_old = np.zeros(n_b)
        d_zeta = rnd(np.full(n_b, float(d_zeta0)))
        d_zeta_old = d_zeta.copy()
        step = np.full(n_b, settings.step0, np.int64)
        trips = np.zeros(n_b, np.int64)
        nits_total = np.zeros(n_b, np.int64)
        ncg_total = np.zeros(n_b, np.int64)
        it = np.zeros(n_b, np.int64)
        crit_prev = np.full(n_b, math.inf)
        newton_trips = [[] for _ in range(n_b)]
        crit_trips = [[] for _ in range(n_b)]
        zeta_stop = rnd(settings.zeta_max - 1e-12)
        d_zeta_min = rnd(settings.d_zeta_min)
        running = np.ones(n_b, bool) & (trips < settings.max_trips)
        zeta = rnd(zeta_old + d_zeta)
        sweeps = reads = 0
        while running.any():
            act = np.nonzero(running)[0]
            whole = act.size == n_b
            a_idx = None if whole else to_dev(act)
            take = (lambda t: t) if whole else (lambda t: t.index_select(0, a_idx))  # noqa: E731
            params = to_dev(np.stack([etas[act], cs[act], zeta[act]], axis=1), torch.float64)
            Ui = take(U_it)
            s, ds, ind_p, _, _ = return_map(Ui, take(ep), params)
            f_int = residual_force(s)
            if solver == "dense":
                dU, n_read = dense_solve(ds, f_int, ind_p)
                reads += n_read
                ok = its = None
            else:
                res = solve_cg_members(
                    lambda v: asm.tangent_matvec(geom_t, ds, v), -f_int, free_mask,
                    precond=block_jacobi_preconditioner(
                        asm.node_block_diagonal(geom_t, ds, slot_map), free_mask),
                    tol=to_dev(cg_tolerances(crit_prev[act]), torch.float64).to(tdtype),
                    maxiter=cg_maxiter,
                )
                dU, ok, its = res.x, res.converged, res.iters
                reads += res.host_reads
            crit = criterion(dU, Ui.to(tdtype))
            fail = torch.isnan(crit) if ok is None else torch.isnan(crit) | ~ok
            U_next = torch.where(fail[:, None], Ui, Ui + dU.to(sdtype))
            if whole:
                U_it = U_next
            else:
                U_it.index_copy_(0, a_idx, U_next)
            # the sweep's one read: the criterion (and the CG flag and count)
            back = [crit.to(torch.float64)]
            if ok is not None:
                back += [ok.to(torch.float64), its.to(torch.float64)]
            host = torch.stack(back).cpu().numpy()
            reads += 1
            sweeps += 1
            crit_h = host[0]
            failed = np.isnan(crit_h)
            if ok is not None:
                failed |= host[1] < 0.5
                ncg_total[act] += host[2].astype(np.int64)
            it[act] += 1
            crit_prev[act] = crit_h
            ends = failed | ~(crit_h >= newton_tol) | (it[act] >= settings.maxit)
            fin = act[ends]
            if not fin.size:
                continue
            crit_fin = np.where(failed[ends], math.nan, crit_h[ends])
            acc = fin[crit_fin < accept_tol]  # NaN compares False
            rej = fin[~(crit_fin < accept_tol)]
            if acc.size:
                c_idx = to_dev(acc)
                U_conv = U_it.index_select(0, c_idx)
                acc_params = to_dev(np.stack([etas[acc], cs[acc], zeta[acc]], axis=1),
                                    torch.float64)
                s_rm, _, _, _, ep_new = return_map(U_conv, ep.index_select(0, c_idx), acc_params,
                                                   apply=accumulate_ep)
                h_idx = to_dev(np.minimum(step[acc], settings.max_steps - 1))
                zeta_hist[c_idx, h_idx] = to_dev(zeta[acc], sdtype)
                mon_hist[c_idx, h_idx] = monitor(U_conv, s_rm).to(sdtype)
                U_old.index_copy_(0, c_idx, U.index_select(0, c_idx))
                U.index_copy_(0, c_idx, U_conv)
                if accumulate_ep:
                    ep.index_copy_(0, c_idx, ep_new)
                zeta_old[acc] = zeta[acc]
                d_zeta_old[acc] = d_zeta[acc]
                step[acc] += 1
            d_zeta[rej] = d_zeta[rej] * 0.5
            # warm start; the divisor is a tensor, as in the single stepper
            f_idx = to_dev(fin)
            Uf, Uof = U.index_select(0, f_idx), U_old.index_select(0, f_idx)
            dz = to_dev(d_zeta[fin], sdtype)[:, None]
            dz_old = to_dev(d_zeta_old[fin], sdtype)[:, None]
            if df_mode:
                U_it.index_copy_(0, f_idx, (Uf - Uof) * (dz / dz_old) + Uf)
                stop = ((zeta_old[fin] - settings.zeta_max) >= -1e-12) | (
                    d_zeta[fin] < settings.d_zeta_min)
            else:
                U_it.index_copy_(0, f_idx, dz * (Uf - Uof) / dz_old + Uf)
                stop = (zeta_old[fin] >= zeta_stop) | (d_zeta[fin] < d_zeta_min)
            nits_total[fin] += it[fin]
            for b, cr in zip(fin, crit_fin):
                newton_trips[b].append(int(it[b]))
                crit_trips[b].append(float(cr))
            trips[fin] += 1
            running[fin] = ~stop & (trips[fin] < settings.max_trips)
            nxt = fin[running[fin]]
            zeta[nxt] = rnd(zeta_old[nxt] + d_zeta[nxt])
            it[nxt] = 0
            crit_prev[nxt] = math.inf
        n_plastic = (ep != 0.0).any(dim=1).sum(dim=1).cpu().numpy()
        ENSEMBLE_STATS.update(runs=1, sweeps=sweeps, host_reads=reads)
        return EnsembleSteppingResult(
            u=U, ep=ep, zeta_hist=zeta_hist, monitor_hist=mon_hist, n_steps=step,
            n_newton_total=nits_total, zeta=zeta_old, n_plastic=n_plastic,
            n_cg_total=ncg_total, newton_trips=tuple(tuple(t) for t in newton_trips),
            crit_trips=tuple(tuple(t) for t in crit_trips), sweeps=sweeps, host_reads=reads,
        )

    return run
