"""Material-parameter ensembles: B tsx solves over (cohesion, friction).

Port of `fem_elastoplasticity_tpu/parallel/ensemble.py`.  The JAX package
batches the whole adaptive solve with `vmap`; here one host controller,
`solve.newton.build_ensemble_stepper`, runs every member through batched
device work: one return map for all running members (kernel K2's
member-batched instance on the native f32 path), batched residuals and
criteria, and batched linear solves.  Each member follows its own adaptive
schedule, that of its single solve.

What does not depend on the material runs once and is shared: the
geometry, the initial-stress force F0, the elastic K_free with its factor
(and, in df32, its Jacobi-scaled explicit inverse Ki), and the elastic
predictor.  The shear and bulk moduli are shared; each member's (eta, c)
come from `material_grid` on the host in float64 and reach the card as a
float64 tensor with a member axis.

With `shard_devices=n` the df32 ensemble runs its members over n ranks
(`parallel.sharding.spawn`, JAX `:151-168`, `:328-345`): the member count
is padded to a multiple of n with copies of member 0, each rank runs its
slice with the batched stepper, and the members' results are gathered in
order (the only collective) and the copies trimmed.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..models import tsx_tunnel as tsx
from ..models.config import TsxTunnelConfig
from ..models.materials import drucker_prager_fit, elastic_tangent_lanes
from ..ops import assembly_df as adf
from ..parallel import sharding
from ..solve.cg import plastic_cg_tol
from ..solve.newton import EnsembleSteppingResult, build_ensemble_stepper
from ..utils.precision import dtype_policy, resolve_device


class EnsembleResult(NamedTuple):
    """Float64 numpy arrays with a leading member axis."""

    u: np.ndarray  # (n_b, n_n, 2)
    zeta_hist: np.ndarray  # (n_b, max_steps)
    monitor_hist: np.ndarray  # (n_b, max_steps)
    n_steps: np.ndarray  # (n_b,)
    n_newton_total: np.ndarray  # (n_b,)
    n_plastic: np.ndarray  # (n_b,)
    # per member: the Newton iterations and the last criterion of each load
    # trip (the port's; the JAX ensemble returns neither)
    newton_trips: tuple = ()
    crit_trips: tuple = ()


def material_grid(cohesions, friction_angles) -> tuple:
    """Cartesian (cohesion x friction) grid -> flat (eta, c) float64 arrays,
    cohesion-major: member i * n_friction + j is (cohesions[i],
    friction_angles[j])."""
    cc, ff = np.meshgrid(cohesions, friction_angles, indexing="ij")
    return drucker_prager_fit(cc.ravel(), ff.ravel())


def _refuse(cfg: TsxTunnelConfig, solver: str) -> None:
    """Raise on what the ensemble does not run: the iterative routes other
    than matrix-free block-Jacobi CG, and the fields that the JAX
    ensemble never reads."""
    if solver in ("ell", "mg"):
        raise NotImplementedError(f"ensemble solver {solver!r}: the multigrid routes run "
                                  "single solves only")
    if solver not in ("dense", "cg"):
        raise NotImplementedError(f"ensemble solver {solver!r}")
    for name, default in (("assembled_cg", False), ("residual_fmt", None),
                          ("cg_cap_relax", None), ("dense_mode", "f64"),
                          ("support_pressure", 0.0), ("cg_structure", "while"),
                          ("cg_deflate", 0)):
        if getattr(cfg, name) != default:
            raise NotImplementedError(f"the ensemble does not read TsxTunnelConfig.{name}="
                                      f"{getattr(cfg, name)!r}")


def _members(etas, cs) -> tuple:
    etas, cs = np.asarray(etas, np.float64).reshape(-1), np.asarray(cs, np.float64).reshape(-1)
    if etas.shape != cs.shape or not etas.size:
        raise ValueError(f"etas {etas.shape} and cs {cs.shape} must be one non-empty shape")
    return etas, cs


def solve_tsx_ensemble(
    etas,
    cs,
    cfg: TsxTunnelConfig = TsxTunnelConfig(),
    solver: Optional[str] = None,
    device=None,
) -> EnsembleResult:
    """B native-precision tsx solves over Drucker-Prager parameters.

    etas, cs: (B,) plane-strain DP parameters (`material_grid`); cfg: a
    native preset (f64, or float32 as `TsxTunnelConfig.fast_f32`); solver
    "dense" or "cg" (default cfg.solver).  The elastic predictor is one
    dense Cholesky solve for every solver, as in the JAX ensemble.  Dense
    f64 factors each member's tangent every Newton iteration; dense f32
    runs the return map in K2's member-batched instance and reuses the
    shared elastic factor while a member has no plastic point, factoring
    only the plastic members.  "cg" runs block-Jacobi PCG on each member's
    matrix-free tangent at `plastic_cg_tol` (1e-14 f64, 2e-7 f32).
    `device`: where to run (`utils.precision.resolve_device`)."""
    solver = solver or cfg.solver
    if cfg.precision != "native":
        raise ValueError("solve_tsx_ensemble runs precision='native'; "
                         "df32 members: solve_tsx_ensemble_df32")
    _refuse(cfg, solver)
    if cfg.bug_compatible_ep_reset:
        raise NotImplementedError("the native ensemble accumulates plastic strain")
    etas, cs = _members(etas, cs)
    device = resolve_device(device)
    dtype = dtype_policy(cfg.precision, cfg.dtype).state
    p = tsx._problem(cfg, device, dtype, dense=True)
    shear, bulk = p.consts[:2]
    D = elastic_tangent_lanes(shear, bulk, p.geom.n_int, dtype, device)
    u_elast, L = tsx._dense_predictor(p, -tsx._initial_force(p), D)
    stepper = build_ensemble_stepper(
        p.geom, p.free_idx, p.plan if solver == "dense" else None, shear, bulk, etas, cs,
        p.settings, monitor=tsx._monitor(cfg.monitor_node), e0_dir=p.e0,
        elastic_factor=("cho", L) if dtype == torch.float32 and solver == "dense" else None,
        solver=solver, cg_tol=plastic_cg_tol(cfg.cg_tol, dtype), cg_maxiter=cfg.cg_maxiter,
    )
    return ensemble_result(stepper(cfg.d_zeta * u_elast, cfg.d_zeta))


def solve_tsx_ensemble_df32(
    etas,
    cs,
    cfg: Optional[TsxTunnelConfig] = None,
    shard_devices: Optional[int] = None,
    device=None,
) -> EnsembleResult:
    """B f64-grade tsx solves over DP parameters: df32 members, f64 state
    and residual with float32 tangent solves (`utils/precision.py`).

    cfg (default `TsxTunnelConfig.fast()`): solver="dense" shares the
    Jacobi-scaled explicit elastic inverse Ki and solves every plastic
    iteration by Woodbury over 128 plastic slots with no fresh-factor
    fallback (`models/tsx_tunnel.py` build_df32 takes 64 with it), as the
    JAX ensemble does; a member with more plastic points than that
    converges more slowly, it does not refactor.  solver="cg" (refined
    meshes): matrix-free block-Jacobi PCG for the shared elastic predictor
    and every member's tangent solves.  `shard_devices`: the members over
    that many ranks (module docstring; `device` as `sharding.spawn` reads
    it: None the card, "cpu" CPU ranks).  A member's batch mates change with
    the rank count, and batched products may round its last bits another
    way (`build_ensemble_stepper`)."""
    cfg = cfg if cfg is not None else TsxTunnelConfig.fast()
    if cfg.precision != "df32":
        raise ValueError("solve_tsx_ensemble_df32 needs precision='df32'")
    _refuse(cfg, cfg.solver)
    etas, cs = _members(etas, cs)
    if shard_devices is not None:
        return sharding.spawn(ensemble_rank, int(shard_devices), etas, cs, cfg, device=device)
    return _ensemble_df32(etas, cs, cfg, resolve_device(device))


def ensemble_rank(group: sharding.ShardGroup, etas: np.ndarray, cs: np.ndarray,
                   cfg: TsxTunnelConfig) -> EnsembleResult:
    """Rank function of the member-sharded ensemble: members padded to a
    multiple of the group size with copies of member 0, this rank's
    contiguous slice solved, every rank's results gathered in order and
    the copies trimmed."""
    n_b = etas.shape[0]
    per = -(-n_b // group.size)
    pad = np.zeros(per * group.size - n_b, np.int64)
    mine = np.concatenate([np.arange(n_b), pad])[group.rank * per:(group.rank + 1) * per]
    parts = group.objects(_ensemble_df32(etas[mine], cs[mine], cfg, group.device))
    return EnsembleResult(*(sum(f, ())[:n_b] if isinstance(f[0], tuple)
                            else np.concatenate(f)[:n_b] for f in zip(*parts)))


def _ensemble_df32(etas: np.ndarray, cs: np.ndarray, cfg: TsxTunnelConfig,
                   device: torch.device) -> EnsembleResult:
    """The df32 ensemble of (etas, cs) on one device."""
    p = tsx._problem(cfg, device)
    shear, bulk = p.consts[:2]
    geom = p.geom
    f0 = tsx._initial_force(p)
    apply_fn = lambda u: adf.elastic_apply(geom, u, shear, bulk)  # noqa: E731
    zero_u = torch.zeros(2 * geom.n_nodes, dtype=torch.float64, device=device)
    Ki = None
    if cfg.solver == "dense":
        D = elastic_tangent_lanes(shear, bulk, geom.n_int, torch.float32, device)
        L, Ki = adf.dense_elastic_factors(geom.to(torch.float32), D, p.plan)
        u_elast = adf.refine_elastic_solve_df(L, p.free_idx, apply_fn, zero_u, -f0)
    else:
        free_mask = torch.as_tensor(p.mesh.free.reshape(-1), device=device)
        u_elast = tsx._df32_cg_predictor(cfg, p, free_mask, -f0, apply_fn)
    stepper = build_ensemble_stepper(
        geom, p.free_idx, p.plan, shear, bulk, etas, cs, p.settings,
        monitor=tsx._monitor(cfg.monitor_node), e0_dir=p.e0,
        elastic_factor=None if Ki is None else ("inv", Ki),
        smw_cap=128 if Ki is not None else None, precision="df32",
        accumulate_ep=not cfg.bug_compatible_ep_reset, solver=cfg.solver,
        cg_tol=plastic_cg_tol(cfg.cg_tol, torch.float32), cg_maxiter=cfg.cg_maxiter,
        cg_eta0=cfg.cg_eta0,
    )
    return ensemble_result(stepper(u_elast * cfg.d_zeta, cfg.d_zeta))


def member_forks(a: EnsembleResult, b: EnsembleResult, newton_tol: float) -> list:
    """The members whose Newton iterations part between two runs of one
    ensemble (on other batches: batched products may round a member's last
    bits another way): [(member, trip (1-based, the first that differs),
    a's count, b's count, the last criterion of the run that stopped first
    on that trip, whether it lies within a decade below newton_tol)].  A
    member that stops one iteration earlier where its criterion sits at
    newton_tol forks without a fault."""
    out = []
    for m, (ta, tb) in enumerate(zip(a.newton_trips, b.newton_trips)):
        if ta == tb:
            continue
        t = next((i for i, (x, y) in enumerate(zip(ta, tb)) if x != y), min(len(ta), len(tb)))
        if t >= min(len(ta), len(tb)):
            out.append((m, t + 1, len(ta), len(tb), float("nan"), False))
            continue
        crit = (a if ta[t] < tb[t] else b).crit_trips[m][t]
        out.append((m, t + 1, ta[t], tb[t], crit, newton_tol / 10.0 <= crit < newton_tol))
    return out


def ensemble_result(res: EnsembleSteppingResult) -> EnsembleResult:
    """EnsembleSteppingResult -> EnsembleResult of float64 numpy arrays."""
    f64 = lambda t: t.detach().to("cpu", torch.float64).numpy()  # noqa: E731
    return EnsembleResult(
        u=f64(res.u).reshape(res.u.shape[0], -1, 2),
        zeta_hist=f64(res.zeta_hist),
        monitor_hist=f64(res.monitor_hist),
        n_steps=np.asarray(res.n_steps, np.int64),
        n_newton_total=np.asarray(res.n_newton_total, np.int64),
        n_plastic=np.asarray(res.n_plastic, np.int64),
        newton_trips=res.newton_trips,
        crit_trips=res.crit_trips,
    )
