"""Write the reference fixtures the PyTorch port's tests read.

Runs the JAX package on the CPU and writes, under tests/fixtures/torch_port/:

* tsx_df32_bench.npz — `TsxTunnelConfig.fast(assembled_cg=True)` (the bench
  preset): u, ep, zeta_hist, displ_hist and the step/Newton/plastic counts;
  plus the native f64 `TsxTunnelConfig()` field as u_f64;
* tsx_df32_carry9.npz — the bench preset's load-stepping carry after 9 load
  trips (`solve/chunked.py carry_of`, written by `save_checkpoint`);
* tsx_f64_maxit2.npz — native f64 with newton_maxit=2: plastic steps fail,
  d_zeta halves until it underflows d_zeta_min (the reject path);
* tsx_f32.npz — `TsxTunnelConfig.fast_f32()`, the pure-f32 preset whose
  return map is the Pallas kernel: u, ep, zeta_hist, displ_hist and the
  step/Newton/plastic counts;
* footing_f64.npz — `FootingConfig()`, the strip footing's native f64
  parity run: u, ep, zeta_hist, pressure_hist and the counts;
* footing_f32.npz — `FootingConfig.fast_f32()`, the same fields;
* tsx_scale_l1.npz — `TsxTunnelConfig.fast_scale(1)`, the multigrid-CG
  scale preset on the once-refined mesh (3,678 DOFs), full schedule: u in
  reference node order, ep, zeta_hist, displ_hist and the step, Newton, CG
  and plastic counts (compressed);
* tsx_scale_l2_2steps.npz — `TsxTunnelConfig.fast_scale(2, zeta_max=2/17)`,
  two load steps on the twice-refined mesh (14,450 DOFs), the same fields;
* tsx_scale_l1_packed.npz — `TsxTunnelConfig.fast_scale(1)` with every
  hierarchy level smoothed from packed bf16 values (`build_hierarchy_ell`'s
  `pack_bf16` default set to True for the run; "auto" packs only levels of
  500,000 rows or more), the same fields;
* tsx_scale_l1_ell.npz — `TsxTunnelConfig.fast_scale(1, spmv_fmt="ell",
  corr_mode="gather", residual_fmt="ell")`: the hierarchy, the CG operator
  and the residual on windowed-ELL operators, the plastic correction
  gathered in every CG product, the same fields;
* tsx_scale_l1_gather.npz, tsx_scale_l1_res_ell.npz, tsx_scale_l1_ell_res_csr.npz
  — the other pairings of the three format options on the same preset:
  CSR hierarchy with the gathered correction (`corr_mode="gather"`), CSR
  hierarchy with the scatter refresh and the ELL residual
  (`residual_fmt="ell"`), ELL hierarchy with the gathered correction and
  the CSR residual; the same fields;
* tsx_df32_bench_res_ell.npz — the bench preset with its residual on ELL
  G/S, `TsxTunnelConfig.fast(assembled_cg=True, residual_fmt="ell")`: u,
  ep, zeta_hist, displ_hist and the counts;
* footing_df32.npz — `FootingConfig.fast()`, the footing's dense
  double-float preset, full schedule: u, ep, zeta_hist, pressure_hist,
  the step, Newton, CG and plastic counts, and newton_trips, the Newton
  iterations of every load trip (from a rerun one trip a dispatch through
  the stepper's resume carry, `solve/chunked.py`, whose totals must equal
  the single run's);
* footing_cg_f64_z0008.npz, footing_cg_f64_z002.npz,
  footing_df32_cg_z002.npz — block-Jacobi PCG tangent solves,
  `FootingConfig(solver="cg", zeta_max=0.008)` and `zeta_max=0.02`
  (native f64; the CPU test takes the first, 7 steps, to stay short; the
  JAX package's native footing does not read max_trips, so these two have
  no newton_trips) and `FootingConfig.fast(solver="cg", zeta_max=0.02)`
  (df32), the same fields;
* footing_df32_acg_z002.npz — the assembled full-tangent operator,
  `FootingConfig.fast(solver="cg", assembled_cg=True, cg_maxiter=4000,
  zeta_max=0.02)`; the JAX package returns it on its RCM node order and
  sorted elements, and the file holds u and ep restored to the reference
  order;
* footing_df32_cg_full.npz, footing_df32_acg_full.npz — the full schedules
  of `FootingConfig.fast(solver="cg")` and `fast(solver="cg",
  assembled_cg=True, cg_maxiter=4000)`, counts only: for every load trip
  (one trip a dispatch, as for newton_trips) its Newton iterations
  (newton_trips), zeta and d_zeta after it (zeta_trips, d_zeta_trips), its
  CG iterations (cg_trips) and whether it accepted a step (accepted_trips);
  the totals and the last recorded pressure.  For `fast(solver="cg")` also
  the CG iterations of the first five Newton iterations of load trip 18
  (probe_trip, probe_newton, probe_cg: that trip replayed with
  newton_maxit=5), the trip where the port's CPU run parts from this one.

* footing_scale_l2_t3.npz, footing_scale_l3_t3.npz — the footing's
  tangent-multigrid scale preset `FootingConfig.fast_scale(L, max_trips=3)`
  at levels 2 and 3 (3,362 and 13,122 DOFs): its first three load trips,
  u and ep on the hierarchy's fine mesh (fine-RCM node order, the mesh the
  JAX package returns), zeta_hist, pressure_hist, the step, Newton, CG and
  plastic counts, and for every trip (one trip a dispatch through the
  stepper's resume carry, deflation ring included, whose totals must equal
  the single run's) its Newton and CG iterations, zeta and d_zeta after it
  and whether it accepted a step;
* footing_scale_l2_damped_t3.npz — the same at level 2 with
  newton_damping=3 (the residual-norm backtracking the preset turns on
  from level 5);
* footing_scale_l2_ckpt2.npz — the level-2 preset's load-stepping carry
  after two load trips, deflation ring (defl_w, defl_ring) included, as
  `save_checkpoint` writes it;
* elasticity_cg.npz — the square-with-hole energies of
  `ElasticityConfig(level=L, solver="cg")` (P1, matrix-free block-Jacobi
  PCG in f64) at levels 3 and 5 (energy_l3, energy_l5).
* tsx_p2_*_z2.npz, tsx_p4_*_z1.npz — the tsx with P2 elements cut at zeta
  2/17 and with P4 elements (the reference's own configuration) cut
  at 1/17, each on five routes, every one its own JAX run:
  `native` = `TsxTunnelConfig(etype, solver="cg")` (native f64
  block-Jacobi PCG), `cg` = `fast(etype, solver="cg")` (df32, matrix-free),
  `acg` = `fast(etype, solver="cg", assembled_cg=True)`, `pmg_gs` /
  `pmg_mf` = `fast(etype, solver="ell")` with gs_tangent True / False
  (p-multigrid, the Pallas kernels in interpret mode): u and ep in the
  reference order, zeta_hist, displ_hist, the step, Newton, CG and plastic
  counts, for the df32 routes newton_trips (Newton iterations a load
  trip; where a trip takes more than one, also cg_trips, CG iterations a
  load trip), and `config`, the run's configuration as JSON (etype, steps: the
  load steps of the cut, zeta_max = steps / 17, and the route's keywords),
  from which the port's tests and `chip_smoke.py` build theirs.  These cuts
  are elastic (every trip one Newton iteration);
* tsx_p2_*_z17.npz, tsx_p4_{native,cg,acg}_z12.npz — the same fields for
  runs that go plastic (plastic flow starts at load step 11): P2 on the
  five routes at the full schedule, P4 on the three block-Jacobi routes cut
  at zeta 12/17 (two plastic steps; the p-multigrid routes in interpret
  mode cost too much at P4);
* tsx_p4_pmg_carry1.npz — the load-stepping carry of the P4 `pmg_gs` run
  after its one load trip (`save_checkpoint`), on the route's permuted node
  order.

* tsx_mg_native_z2.npz, tsx_mg_df32_z2.npz, tsx_support_p1.npz,
  tsx_scale_l1_w.npz, tsx_scale_l1_defl4_z3.npz — the tsx options of
  `TSX_OPTIONS` (the matrix-free multigrid native and df32, the support
  pressure over the full schedule, the W-cycle, the deflated CG cut at
  3/17 and over the full schedule, tsx_scale_l1_defl4.npz): the fields, the
  CG count, the configuration as JSON under `config` and, for df32 runs,
  newton_trips and cg_trips;
* tsx_scale_l1_ckpt3.npz — the load-stepping carry of
  `TsxTunnelConfig.fast_scale(1)` after 3 load trips, written by
  `solve/chunked.py save_checkpoint` (the port resumes it);
* ensemble_f64.npz, ensemble_df32.npz, ensemble_df32_weak.npz,
  ensemble_df32_cg_l1.npz — material ensembles (`parallel/ensemble.py`)
  over `material_grid(cohesions, friction angles)`: the native f64 dense
  ensemble of (15, 18.7) x 49 deg, the df32 dense ensembles of (18.7, 25)
  x 49 deg and of the weak member (4, 18.7) x 49 deg, and the df32
  matrix-free CG ensemble `fast(solver="cg", refine_levels=1,
  zeta_max=2/17)` of (16, 18.7) x (45, 49) deg: per member u (n_b, n_n,
  2), zeta_hist, monitor_hist and the step, Newton and plastic counts,
  beside the grid (cohesions, frictions) and its (eta, c).
* tsx_sharded_cg_n3_z3.npz — the element-sharded matrix-free CG solve
  `solve_sharded(TsxTunnelConfig(zeta_max=3/17), n_devices=3)` on a
  virtual three-device CPU mesh (the run sets
  `--xla_force_host_platform_device_count=3` before JAX starts): u, ep,
  zeta_hist, displ_hist and the step, Newton, CG and plastic counts.
* benchmark_sweeps.json (name `sweeps`) — the JAX package's sweeps
  (`fem_elastoplasticity_tpu/benchmarks/`) at the port's test sizes, their
  deterministic fields only (no time): the assembly sweep at levels 0-1 (elements, DOFs),
  `run_solve_sweep` at level 0 with the multigrid and the block-Jacobi
  preconditioner (DOFs, CG iterations), `spmv_bench.main(0)` (its printed
  line: DOFs, nnz), `run_dp_scale` at level 1 cut at zeta 3/17 (steps,
  Newton, CG, plastic, u40), `run_elastic_df32_sweep` and
  `run_elastic_ell_sweep` (formats "slot" and "ell") at level 1 (CG
  iterations a refinement pass, u_max), `run_ensemble_bench` on the 2 x 2
  grid (min/max steps, f32 and df32) and `run_footing_scale` at level 1 cut
  at zeta 0.02 (steps, Newton, CG, plastic, limit pressure, zeta_end).

The port's tests compare against these files instead of re-running a JAX
solve (about 30 s of compilation each; the two scale files run their
Pallas kernels in interpret mode and take about 35 s and 45 s, the packed
and ELL ones about 60 s and 70 s each).
Run from the repository root, optionally naming the files to write
(default: all):

    python tools/make_port_fixtures.py [tsx_f32 footing_f64 ...]
"""
from __future__ import annotations

import contextlib
import dataclasses
import functools
import json
import os
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "fixtures" / "torch_port"


def _fields(r, monitor: str) -> dict:
    import numpy as np

    return dict(
        u=np.asarray(r.u, np.float64),
        ep=np.asarray(r.ep, np.float64),
        zeta_hist=np.asarray(r.zeta_hist, np.float64),
        **{monitor: np.asarray(getattr(r, monitor), np.float64)},
        n_steps=r.n_steps,
        n_newton_total=r.n_newton_total,
        n_plastic=r.n_plastic,
    )


def main(names) -> None:
    sys.path.insert(0, str(ROOT))
    if SHARDED in (names or FIXTURES):
        # the virtual devices of the sharded run exist only if XLA reads the
        # flag before its CPU backend starts
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " "
                                   f"--xla_force_host_platform_device_count={SHARDED_DEVICES}"
                                   ).strip()
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from fem_elastoplasticity_tpu.models import footing
    from fem_elastoplasticity_tpu.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu.models.config import FootingConfig, TsxTunnelConfig
    from fem_elastoplasticity_tpu.solve.chunked import carry_of, save_checkpoint

    OUT.mkdir(parents=True, exist_ok=True)
    names = set(names or FIXTURES)
    if "tsx_f32" in names:
        r = tsx.solve(TsxTunnelConfig.fast_f32())
        np.savez(OUT / "tsx_f32.npz", **_fields(r, "displ_hist"))
    if "footing_f64" in names:
        r = footing.solve(FootingConfig())
        np.savez(OUT / "footing_f64.npz", **_fields(r, "pressure_hist"))
    if "footing_f32" in names:
        r = footing.solve(FootingConfig.fast_f32())
        np.savez(OUT / "footing_f32.npz", **_fields(r, "pressure_hist"))
    for name, cfg, pack in (
        ("tsx_scale_l1", lambda: TsxTunnelConfig.fast_scale(1), "auto"),
        ("tsx_scale_l2_2steps", lambda: TsxTunnelConfig.fast_scale(2, zeta_max=2 / 17), "auto"),
        ("tsx_scale_l1_packed", lambda: TsxTunnelConfig.fast_scale(1), True),
        ("tsx_scale_l1_ell", lambda: TsxTunnelConfig.fast_scale(
            1, spmv_fmt="ell", corr_mode="gather", residual_fmt="ell"), "auto"),
        ("tsx_scale_l1_gather", lambda: TsxTunnelConfig.fast_scale(1, corr_mode="gather"), "auto"),
        ("tsx_scale_l1_res_ell", lambda: TsxTunnelConfig.fast_scale(1, residual_fmt="ell"), "auto"),
        ("tsx_scale_l1_ell_res_csr", lambda: TsxTunnelConfig.fast_scale(
            1, spmv_fmt="ell", corr_mode="gather"), "auto"),
    ):
        if name in names:
            with _pack_bf16(pack):
                r = tsx.solve(cfg())
            np.savez_compressed(
                OUT / f"{name}.npz", **_fields(r, "displ_hist"), n_cg_total=r.n_cg_total
            )
    if "tsx_df32_bench_res_ell" in names:
        r = tsx.solve(TsxTunnelConfig.fast(assembled_cg=True, residual_fmt="ell"))
        np.savez_compressed(OUT / "tsx_df32_bench_res_ell.npz", **_fields(r, "displ_hist"))
    for name, (cfg, probe) in FOOTING_FULL.items():
        if name in names:
            cfg = cfg(FootingConfig)
            r = footing.solve(cfg)
            extra = {}
            if probe is not None:
                trip, n_newton = probe
                extra = dict(probe_trip=trip, probe_newton=n_newton,
                             probe_cg=_trip_cg_prefix(footing, cfg, trip, n_newton))
            np.savez(OUT / f"{name}.npz", **_trip_record(footing, cfg, r), **extra,
                     n_steps=r.n_steps, n_newton_total=r.n_newton_total,
                     n_cg_total=r.n_cg_total, n_plastic=r.n_plastic,
                     last_pressure=float(np.asarray(r.pressure_hist)[r.n_steps]))
    for name, cfg in FOOTING_RUNS.items():
        if name in names:
            cfg = cfg(FootingConfig)
            r = footing.solve(cfg)
            fields = _fields(r, "pressure_hist")
            if cfg.assembled_cg:
                fields.update(_footing_reference_order(footing, cfg, fields))
            if cfg.precision == "df32":
                fields["newton_trips"] = _trip_record(footing, cfg, r)["newton_trips"]
            np.savez_compressed(OUT / f"{name}.npz", **fields, n_cg_total=r.n_cg_total)
    if "elasticity_cg" in names:
        from fem_elastoplasticity_tpu.models import elasticity
        from fem_elastoplasticity_tpu.models.config import ElasticityConfig

        np.savez(OUT / "elasticity_cg.npz", **{
            f"energy_l{lvl}": float(elasticity.solve(ElasticityConfig(level=lvl,
                                                                       solver="cg")).energy)
            for lvl in (3, 5)})
    for name, (cfg, n_trips, ckpt) in FOOTING_SCALE.items():
        if name in names or (ckpt is not None and ckpt in names):
            cfg = cfg(FootingConfig)
            r = footing.solve(cfg)
            rec = _trip_record(footing, cfg, r, n_trips=n_trips,
                               checkpoint=(ckpt is not None and ckpt in names and
                                           (OUT / f"{ckpt}.npz", 2)))
            np.savez_compressed(OUT / f"{name}.npz", **_fields(r, "pressure_hist"), **rec,
                                n_cg_total=r.n_cg_total)
    from fem_elastoplasticity_tpu.ops.elements import ElementType

    for name, (et, steps, route) in HIGH_ORDER.items():
        if name in names or (name == "tsx_p4_pmg_gs_z1" and "tsx_p4_pmg_carry1" in names):
            kw = HIGH_ORDER_ROUTES[route]
            cfg = TsxTunnelConfig(etype=ElementType[et], zeta_max=steps / 17, **kw)
            extra = {"config": json.dumps(dict(etype=et, steps=steps, route=route, **kw))}
            if cfg.precision == "df32":
                run, args, mesh = tsx.build_df32(cfg, extras=(extras := {}))
                res = run(args)
                r = tsx._df32_result(res, extras, cfg, mesh)
                if r.n_newton_total == r.n_steps:
                    # every trip accepted a step after one Newton iteration
                    extra["newton_trips"] = np.ones(r.n_steps, np.int64)
                else:
                    rec = _trip_record(tsx, cfg, r, step0=0)
                    extra.update(newton_trips=rec["newton_trips"], cg_trips=rec["cg_trips"])
                if name == "tsx_p4_pmg_gs_z1" and "tsx_p4_pmg_carry1" in names:
                    save_checkpoint(OUT / "tsx_p4_pmg_carry1.npz", carry_of(res))
            else:
                r = tsx.solve(cfg)
            if name in names:
                np.savez_compressed(OUT / f"{name}.npz", **_fields(r, "displ_hist"), **extra,
                                    n_cg_total=r.n_cg_total)
    for name, (preset, kw) in TSX_OPTIONS.items():
        if name in names:
            cfg = tsx_option_config(TsxTunnelConfig, ElementType, preset, kw)
            extra = {"config": json.dumps(dict(preset=preset, **kw))}
            if cfg.precision == "df32":
                run, args, mesh = tsx.build_df32(cfg, extras=(extras := {}))
                r = tsx._df32_result(run(args), extras, cfg, mesh)
                rec = _trip_record(tsx, cfg, r, step0=0)
                extra.update(newton_trips=rec["newton_trips"], cg_trips=rec["cg_trips"])
            else:
                r = tsx.solve(cfg)
            np.savez_compressed(OUT / f"{name}.npz", **_fields(r, "displ_hist"), **extra,
                                n_cg_total=r.n_cg_total)
    if "tsx_scale_l1_ckpt3" in names:
        run, args, _ = tsx.build_df32(TsxTunnelConfig.fast_scale(1, max_trips=3))
        save_checkpoint(OUT / "tsx_scale_l1_ckpt3.npz", carry_of(run(args)))
    for name, (cohesions, frictions, df32, cfg_kw) in ENSEMBLES.items():
        if name in names:
            from fem_elastoplasticity_tpu.parallel import ensemble as ens

            # radians as TsxTunnelConfig's default forms 49 deg: 49.0 * pi / 180
            eta, c = ens.material_grid(np.asarray(cohesions),
                                       np.asarray(frictions) * np.pi / 180.0)
            cfg = (TsxTunnelConfig.fast if df32 else TsxTunnelConfig)(**cfg_kw)
            e = (ens.solve_tsx_ensemble_df32(eta, c, cfg=cfg) if df32
                 else ens.solve_tsx_ensemble(eta, c, cfg))
            np.savez_compressed(
                OUT / f"{name}.npz", cohesions=np.asarray(cohesions, np.float64),
                frictions_deg=np.asarray(frictions, np.float64), eta=eta, c=c,
                u=np.asarray(e.u, np.float64), zeta_hist=np.asarray(e.zeta_hist, np.float64),
                monitor_hist=np.asarray(e.monitor_hist, np.float64),
                n_steps=np.asarray(e.n_steps), n_newton_total=np.asarray(e.n_newton_total),
                n_plastic=np.asarray(e.n_plastic), config=json.dumps(dict(df32=df32, **cfg_kw)))
    if SWEEPS in names:
        _sweeps()
    if SHARDED in names:
        r = tsx.solve_sharded(TsxTunnelConfig(zeta_max=3 / 17), n_devices=SHARDED_DEVICES)
        np.savez_compressed(OUT / f"{SHARDED}.npz", **_fields(r, "displ_hist"),
                            n_cg_total=r.n_cg_total)
    if not names & {"tsx_df32_bench", "tsx_f64_maxit2", "tsx_df32_carry9"}:
        _report()
        return

    cfg = TsxTunnelConfig.fast(assembled_cg=True)
    r = tsx.solve(cfg)
    r64 = tsx.solve(TsxTunnelConfig())
    np.savez(
        OUT / "tsx_df32_bench.npz",
        u=np.asarray(r.u, np.float64),
        ep=np.asarray(r.ep, np.float64),
        zeta_hist=np.asarray(r.zeta_hist, np.float64),
        displ_hist=np.asarray(r.displ_hist, np.float64),
        n_steps=r.n_steps,
        n_newton_total=r.n_newton_total,
        n_plastic=r.n_plastic,
        u_f64=np.asarray(r64.u, np.float64),
    )

    r2 = tsx.solve(TsxTunnelConfig(newton_maxit=2))
    np.savez(
        OUT / "tsx_f64_maxit2.npz",
        u=np.asarray(r2.u, np.float64),
        zeta_hist=np.asarray(r2.zeta_hist, np.float64),
        displ_hist=np.asarray(r2.displ_hist, np.float64),
        n_steps=r2.n_steps,
        n_newton_total=r2.n_newton_total,
    )

    run, args, _ = tsx.build_df32(dataclasses.replace(cfg, max_trips=9))
    save_checkpoint(OUT / "tsx_df32_carry9.npz", carry_of(run(args)))
    _report()


@contextlib.contextmanager
def _pack_bf16(pack):
    """Run with `build_hierarchy_ell`'s `pack_bf16` default set to `pack`
    (the tsx model calls it without the argument)."""
    from fem_elastoplasticity_tpu.solve import multigrid as mgm

    real = mgm.build_hierarchy_ell
    mgm.build_hierarchy_ell = functools.partial(real, pack_bf16=pack)
    try:
        yield
    finally:
        mgm.build_hierarchy_ell = real


def _footing_reference_order(footing, cfg, fields) -> dict:
    """u and ep of an assembled footing run, moved from the RCM node order
    and the sorted element order that `footing.build_df32` runs on back to
    the reference mesh's order."""
    import numpy as np

    from fem_elastoplasticity_tpu.ops import spmv

    mesh = footing.build_mesh(cfg)
    order = spmv.rcm_node_order(np.asarray(mesh.elems), mesh.n_nodes)
    _, elems2, new_of_old = spmv.permute_mesh(
        np.asarray(mesh.coords, np.float64), np.asarray(mesh.elems), order)
    esort = np.argsort(elems2.min(axis=1), kind="stable")
    ep = fields["ep"].copy()
    n_real = esort.size  # P1: one point an element
    ep[:, esort] = fields["ep"][:, :n_real]
    return dict(u=fields["u"][new_of_old], ep=ep)


def _trip_record(footing, cfg, r, n_trips=None, checkpoint=None, step0=1) -> dict:
    """Every load trip of a df32 footing run: the run again, one trip a
    dispatch through the stepper's resume carry, its totals held to the
    single run's `r`.  Per trip: Newton and CG iterations, zeta and d_zeta
    after it, and whether it accepted a step.  `n_trips`: the run `r` was
    cut at that many trips (cfg.max_trips); `checkpoint`: (path, trips),
    write the carry after that many trips with `save_checkpoint`.  `footing`
    may be the tsx module, whose step count starts at `step0` = 0 (the
    footing's at 1)."""
    import numpy as np

    from fem_elastoplasticity_tpu.solve.chunked import carry_of, save_checkpoint

    run, args, _ = footing.build_df32(dataclasses.replace(cfg, max_trips=1))
    res, total, cg, steps = run(args), 0, 0, step0
    rec = {k: [] for k in ("newton_trips", "cg_trips", "zeta_trips", "d_zeta_trips",
                           "accepted_trips")}
    while True:
        zeta = float(res.zeta.hi) + float(res.zeta.lo)
        d_zeta = float(res.d_zeta.hi) + float(res.d_zeta.lo)
        rec["newton_trips"].append(int(res.n_newton_total) - total)
        rec["cg_trips"].append(int(res.n_cg_total) - cg)
        rec["zeta_trips"].append(zeta)
        rec["d_zeta_trips"].append(d_zeta)
        rec["accepted_trips"].append(int(res.n_steps) - steps)
        total, cg, steps = int(res.n_newton_total), int(res.n_cg_total), int(res.n_steps)
        if checkpoint and len(rec["newton_trips"]) == checkpoint[1]:
            save_checkpoint(checkpoint[0], carry_of(res))
        if len(rec["newton_trips"]) == n_trips:
            break
        if zeta >= cfg.zeta_max - 1e-12 or d_zeta < cfg.d_zeta * cfg.d_zeta_min_ratio:
            break
        res = run(args, carry_of(res))
    if (total, int(res.n_steps) - step0, int(res.n_cg_total)) != (
            r.n_newton_total, r.n_steps, r.n_cg_total):
        raise RuntimeError(f"{cfg}: the one-trip dispatches left the single run's schedule")
    return {k: np.asarray(v, np.float64 if "zeta" in k else np.int64) for k, v in rec.items()}


def _trip_cg_prefix(footing, cfg, trip: int, n_newton: int) -> int:
    """CG iterations of the first `n_newton` Newton iterations of load trip
    `trip` (1-based, > 1) of a df32 footing run: the trips before it one a
    dispatch, then that trip alone under newton_maxit=n_newton."""
    from fem_elastoplasticity_tpu.solve.chunked import carry_of

    run, args, _ = footing.build_df32(dataclasses.replace(cfg, max_trips=1))
    res = run(args)
    for _ in range(trip - 2):
        res = run(args, carry_of(res))
    run_m, args_m, _ = footing.build_df32(
        dataclasses.replace(cfg, max_trips=1, newton_maxit=n_newton))
    n0, cg0 = int(res.n_newton_total), int(res.n_cg_total)
    res = run_m(args_m, carry_of(res))
    if int(res.n_newton_total) - n0 != n_newton:
        raise RuntimeError(f"{cfg}: trip {trip} ended before {n_newton} Newton iterations")
    return int(res.n_cg_total) - cg0


def _sweeps() -> None:
    """benchmark_sweeps.json: the JAX sweeps' deterministic fields at the
    sizes of tests/test_torch_benchmarks.py (module docstring)."""
    import io

    import numpy as np

    from fem_elastoplasticity_tpu.benchmarks import (
        dp_scale_bench, elastic_df32_sweep, elastic_ell_sweep, ensemble_bench,
        footing_scale_bench, spmv_bench)
    from fem_elastoplasticity_tpu.benchmarks import run_assembly_sweep, run_solve_sweep

    def keep(rec, keys):
        return {k: rec[k] for k in keys}

    out = {"assembly": [keep(r, ("level", "n_elems", "n_dofs"))
                        for r in run_assembly_sweep(levels=1, reps=1, verbose=False)]}
    for pre in ("mg", "jacobi"):
        out[f"solve_{pre}"] = keep(
            run_solve_sweep(levels=(0,), reps=1, verbose=False, preconditioner=pre)[0],
            ("level", "n_elems", "n_dofs", "cg_iters"))
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        spmv_bench.main(0, reps=1)
    out["spmv"] = keep(json.loads(buf.getvalue().strip().splitlines()[-1]),
                       ("level", "n_dofs", "nnz"))
    out["dp_scale"] = keep(
        dp_scale_bench.run_dp_scale(levels=(1,), reps=1, verbose=False, zeta_max=3 / 17)[0],
        ("level", "n_elems", "n_dofs", "n_steps", "n_newton_total", "n_cg_total",
         "n_plastic", "u40"))
    ir = ("level", "n_elems", "n_dofs", "cg_iters_per_ir_pass", "u_max")
    out["elastic_df32"] = keep(
        elastic_df32_sweep.run_elastic_df32_sweep(levels=(1,), reps=1, verbose=False)[0], ir)
    for fmt in ("slot", "ell"):
        out[f"elastic_ell_{fmt}"] = keep(elastic_ell_sweep.run_elastic_ell_sweep(
            levels=(1,), reps=1, verbose=False, fmt=fmt)[0], ir)
    out["ensemble"] = keep(
        ensemble_bench.run_ensemble_bench(2, 2, verbose=False),
        ("ensemble_size", "min_steps", "max_steps", "df32_min_steps", "df32_max_steps"))
    out["footing"] = keep(
        footing_scale_bench.run_footing_scale(levels=(1,), reps=0, verbose=False,
                                              zeta_max=0.02)[0],
        ("level", "n_elems", "n_dofs", "n_steps", "n_newton_total", "n_cg_total",
         "n_plastic", "limit_pressure", "zeta_end"))
    out["config"] = {"dp_scale": {"level": 1, "zeta_max": 3 / 17},
                     "footing": {"level": 1, "zeta_max": 0.02}, "ensemble": [2, 2]}
    out = json.loads(json.dumps(out, default=lambda x: np.asarray(x).tolist()))
    (OUT / "benchmark_sweeps.json").write_text(json.dumps(out, indent=1) + "\n")


def _report() -> None:
    for f in sorted(OUT.glob("*.npz")):
        print(f.relative_to(ROOT), f.stat().st_size, "bytes")


FOOTING_RUNS = {
    "footing_df32": lambda F: F.fast(),
    "footing_cg_f64_z0008": lambda F: F(solver="cg", zeta_max=0.008),
    "footing_cg_f64_z002": lambda F: F(solver="cg", zeta_max=0.02),
    "footing_df32_cg_z002": lambda F: F.fast(solver="cg", zeta_max=0.02),
    "footing_df32_acg_z002": lambda F: F.fast(
        solver="cg", assembled_cg=True, cg_maxiter=4000, zeta_max=0.02),
}
# name: (config, (load trip, Newton iterations) to probe or None)
FOOTING_FULL = {
    "footing_df32_cg_full": (lambda F: F.fast(solver="cg"), (18, 5)),
    "footing_df32_acg_full": (
        lambda F: F.fast(solver="cg", assembled_cg=True, cg_maxiter=4000), None),
}
# name: (config, load trips, the checkpoint fixture its trip record writes)
FOOTING_SCALE = {
    "footing_scale_l2_t3": (lambda F: F.fast_scale(2, max_trips=3), 3,
                            "footing_scale_l2_ckpt2"),
    "footing_scale_l3_t3": (lambda F: F.fast_scale(3, max_trips=3), 3, None),
    "footing_scale_l2_damped_t3": (
        lambda F: F.fast_scale(2, max_trips=3, newton_damping=3), 3, None),
}
# the P2 / P4 route fixtures: route -> TsxTunnelConfig keywords (each
# fixture stores its own as `config`; nothing else holds this table)
HIGH_ORDER_ROUTES = {
    "native": dict(solver="cg"),
    "cg": dict(solver="cg", precision="df32", dtype="float32"),
    "acg": dict(solver="cg", assembled_cg=True, precision="df32", dtype="float32"),
    "pmg_gs": dict(solver="ell", gs_tangent=True, precision="df32", dtype="float32"),
    "pmg_mf": dict(solver="ell", gs_tangent=False, precision="df32", dtype="float32"),
}
# element type, load steps of the cut (zeta_max = steps / 17), routes
HIGH_ORDER_CUTS = (("P2", 2, tuple(HIGH_ORDER_ROUTES)), ("P4", 1, tuple(HIGH_ORDER_ROUTES)),
                   ("P2", 17, tuple(HIGH_ORDER_ROUTES)), ("P4", 12, ("native", "cg", "acg")))
HIGH_ORDER = {f"tsx_{et.lower()}_{route}_z{steps}": (et, steps, route)
              for et, steps, routes in HIGH_ORDER_CUTS for route in routes}
# material ensembles: name -> (cohesions, friction angles in degrees, df32,
# TsxTunnelConfig keywords; df32 ones on top of `fast`)
ENSEMBLES = {
    "ensemble_f64": ((15.0, 18.7), (49.0,), False, {}),
    "ensemble_df32": ((18.7, 25.0), (49.0,), True, {}),
    "ensemble_df32_weak": ((4.0, 18.7), (49.0,), True, {}),
    "ensemble_df32_cg_l1": ((16.0, 18.7), (45.0, 49.0), True,
                            dict(solver="cg", refine_levels=1, zeta_max=2.0 / 17.0)),
}
# the tsx options of the last single-device slice: name -> (preset, keywords);
# preset None (the plain config), "fast" or ["fast_scale", level]; "etype"
# by name
TSX_OPTIONS = {
    "tsx_mg_native_z2": (None, dict(solver="mg", refine_levels=1, zeta_max=2 / 17)),
    "tsx_mg_df32_z2": ("fast", dict(solver="mg", refine_levels=1, zeta_max=2 / 17)),
    "tsx_support_p1": (None, dict(solver="cg", support_pressure=2.0)),
    "tsx_scale_l1_w": (["fast_scale", 1], dict(mg_cycle="w")),
    "tsx_scale_l1_defl4_z3": (["fast_scale", 1], dict(cg_deflate=4, zeta_max=3 / 17)),
    "tsx_scale_l1_defl4": (["fast_scale", 1], dict(cg_deflate=4)),
}
# not in TSX_OPTIONS: `fast(etype=P2, solver="ell", residual_fmt="ell")`
# fails in the JAX package (its elastic_apply_gs32 reads the column-split
# ELL S as one slot operator: KeyError 'vals_hi', `ops/assembly_df.py:319`
# from `models/tsx_tunnel.py:817`); the port's run is held against the CSR
# routes' fixtures (`tsx_p2_pmg_mf_z2`, `tsx_p2_pmg_gs_z2`)


def tsx_option_config(config_cls, element_type, preset, kw):
    """The configuration of a `TSX_OPTIONS` entry (or of its JSON `config`)
    from a package's `TsxTunnelConfig` and `ElementType`."""
    kw = dict(kw)
    if "etype" in kw:
        kw["etype"] = element_type[kw["etype"]]
    if preset is None:
        return config_cls(**kw)
    if preset == "fast":
        return config_cls.fast(**kw)
    return config_cls.fast_scale(preset[1], **kw)


# the JAX sweeps of fem_elastoplasticity_tpu/benchmarks/ at the port's test sizes
SWEEPS = "sweeps"  # writes benchmark_sweeps.json

# the element-sharded solve on a virtual CPU mesh of this many devices
SHARDED, SHARDED_DEVICES = "tsx_sharded_cg_n3_z3", 3

FIXTURES = (
    "tsx_df32_bench", "tsx_f64_maxit2", "tsx_df32_carry9",
    "tsx_f32", "footing_f64", "footing_f32", "tsx_scale_l1", "tsx_scale_l2_2steps",
    "tsx_scale_l1_packed", "tsx_scale_l1_ell", "tsx_scale_l1_gather", "tsx_scale_l1_res_ell",
    "tsx_scale_l1_ell_res_csr", "tsx_df32_bench_res_ell", *FOOTING_RUNS, *FOOTING_FULL,
    *FOOTING_SCALE, "footing_scale_l2_ckpt2", "elasticity_cg", *HIGH_ORDER,
    "tsx_p4_pmg_carry1", *ENSEMBLES, *TSX_OPTIONS, "tsx_scale_l1_ckpt3", SHARDED, SWEEPS,
)

if __name__ == "__main__":
    unknown = set(sys.argv[1:]) - set(FIXTURES)
    if unknown:
        sys.exit(f"unknown fixtures {sorted(unknown)}; known: {FIXTURES}")
    main(sys.argv[1:])
