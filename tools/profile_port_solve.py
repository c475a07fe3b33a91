"""Profile the PyTorch port's solves on one CUDA card.

The solves: tsx native f64, the tsx bench preset (df32), tsx `fast_f32`
(kernel K2), and the footing in native f64 and `fast_f32` (K2).  Runs each
solve once to warm up, five times on the host clock, then once under
`torch.profiler`, and reports the host wall, the device busy time (sum of
kernel times on the one stream the solver uses), the device idle share, the
kernel launch count and the kernels that take the most device time.  Writes the profiler tables to
OUT (default `profile_port_solve.txt`) and prints one JSON summary line.

With `--scale L [L ...]` it also profiles the scale preset
`TsxTunnelConfig.fast_scale(L)` (multigrid-preconditioned CG; kernels K3,
K4 and K1, and K5 at level 5) at each level given: the host setup time of
`build_df32`, then the same measurements, the step / Newton / CG / plastic
counts, the launches of each hand-written kernel, and the host syncs per
CG iteration (host reads of a device scalar, and `cudaStreamSynchronize`
calls, in the profiled run, over its CG total).  `--ell L [L ...]` does
the same for the ELL configuration `fast_scale(L, spmv_fmt="ell",
corr_mode="gather", residual_fmt="ell")` (kernel K6).  `--no-dense`
leaves the five dense solves out.

`--footing` runs the footing's four level-1 double-float and CG
configurations at their full schedules, once each: `FootingConfig.fast()`
(dense), `FootingConfig(solver="cg")` (native f64 block-Jacobi PCG),
`FootingConfig.fast(solver="cg")` and `FootingConfig.fast(solver="cg",
assembled_cg=True, cg_maxiter=4000)` (kernel K3 for the CG products, K1
for the residual).  It reports each run's wall, its step / Newton / CG /
plastic counts beside the JAX package's and its last pressure against the
dense f64 run's, then profiles one run of the same configuration cut to
its first load trip (the full CG schedules make 170,000-230,000 CG
iterations of some 40 kernels each, too many events for the profiler):
idle share, top kernels, launches, kernels and host reads per CG
iteration.  Last it times, without the profiler, the assembled preset at
level 4 (25,921 nodes, 51,342 unknowns) for its first two load trips
(`max_trips=2`): setup, wall, counts and launches.

`--high-order` profiles the tsx's high-order production route,
p-multigrid with the tangent on the f32 heads of G and S
(`TsxTunnelConfig.fast(etype, solver="ell")`: kernels K1, K3's CSR kernel
and transfers, K4) at its full schedule: P4 on the tsx mesh (14,452
DOFs), P4 refine 2 and P2 refine 3 (228,112 DOFs each), with the same
measurements as `--scale` and, for every scale configuration, the peak
device memory of its setup and first run above what was held before.

`--footing-scale L [L ...]` runs the footing's tangent-multigrid preset
`FootingConfig.fast_scale(L)` (kernels K1, K3 with its CSR kernel on the
Galerkin maps, K4): at levels 2-4 its first three load trips
(`max_trips=3`), at level 5 one load trip resumed from the banked
checkpoint `checkpoints/footing_l5_k16.npz`.  It reports the host setup,
a first and two timed walls, the counts, the wall per CG iteration and the
launches, then profiles one run (at level 5 the resumed trip cut to its
first three Newton iterations, `newton_maxit=3`, to keep the profile's
events in hand): device idle share, top kernels, kernels and host syncs
per CG iteration.

    python tools/profile_port_solve.py [OUT] [--scale L ...] [--ell L ...] [--no-dense]
                                       [--footing] [--footing-scale L ...] [--high-order]
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
# the JAX package's full level-1 footing runs on the CPU: steps / Newton /
# CG / plastic and the last accepted pressure; the dense run's are read from
# its fixture (tools/make_port_fixtures.py), the CG runs have none
FOOTING_FULL = {
    "footing_df32": (dict(), None, None),
    "footing_f64_cg": (dict(solver="cg"), (28, 166, 223774, 776), 16.836019),
    "footing_df32_cg": (dict(solver="cg"), (24, 170, 196042, 776), 16.836052),
    "footing_df32_acg": (dict(solver="cg", assembled_cg=True, cg_maxiter=4000),
                         (17, 130, 177800, 775), 16.836193),
}


def profiled(torch, profile, activities, run):
    """(result, host wall, profile) of one run under torch.profiler."""
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        res = run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return res, wall, prof


def device_summary(prof, wall: float) -> dict:
    """Busy time, idle share, kernel count and top kernels of a profile."""
    kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time_total for e in kernels)
    top = {}
    for e in kernels:
        top[e.name] = top.get(e.name, 0.0) + e.device_time_total
    top = sorted(top.items(), key=lambda kv: -kv[1])[:8]
    host = [e for e in prof.events() if e.device_type.name != "CUDA"]
    return dict(
        wall_profiled_s=wall,
        device_busy_s=busy_us * 1e-6,
        device_idle_share=1.0 - busy_us * 1e-6 / wall,
        kernel_launches=len(kernels),
        host_scalar_reads=sum(e.name == "aten::_local_scalar_dense" for e in host),
        top_kernels_ms={k[:80]: v * 1e-3 for k, v in top},
    )


def footing_runs(torch, profile, activities, device, card, tables) -> dict:
    """The `--footing` measurements (module doc)."""
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
    from fem_elastoplasticity_tpu_torch.ops import spmv

    p64 = float(footing.solve(FootingConfig(), device=device).pressure_hist[16])
    out = {"dense_f64_last_pressure": p64}
    for tag, (kw, jax_counts, jax_p) in FOOTING_FULL.items():
        if jax_counts is None:
            import numpy as np

            f = np.load(ROOT / "tests" / "fixtures" / "torch_port" / f"{tag}.npz")
            jax_counts = tuple(int(f[k]) for k in (
                "n_steps", "n_newton_total", "n_cg_total", "n_plastic"))
            jax_p = float(f["pressure_hist"][jax_counts[0]])
        cfg = (FootingConfig if tag == "footing_f64_cg" else FootingConfig.fast)(**kw)
        spmv.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        r = footing.solve(cfg, device=device)
        wall = time.perf_counter() - t0
        p = float(r.pressure_hist[r.n_steps])
        rec = dict(
            wall_s=wall,
            counts=[r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic],
            jax_counts=list(jax_counts),
            zeta_reached=float(r.zeta_hist[r.n_steps]),
            last_pressure=p, jax_last_pressure=jax_p,
            last_pressure_rel_to_dense_f64=abs(p - p64) / p64,
            kernel_launches_by_name=dict(spmv.LAUNCHES),
            cg_iteration_us=1e6 * wall / r.n_cg_total if r.n_cg_total else None,
        )
        cut = cfg if not r.n_cg_total else dataclasses.replace(cfg, max_trips=1)
        footing.solve(cut, device=device)  # warm
        res, wall_p, prof = profiled(torch, profile, activities,
                                     lambda: footing.solve(cut, device=device))
        dev = device_summary(prof, wall_p)
        if res.n_cg_total:
            dev.update(
                profiled_counts=[res.n_steps, res.n_newton_total, res.n_cg_total, res.n_plastic],
                device_kernels_per_cg_iteration=dev["kernel_launches"] / res.n_cg_total,
                host_scalar_reads_per_cg_iteration=dev["host_scalar_reads"] / res.n_cg_total,
            )
        rec["profiled_run" + ("_1_trip" if res.n_cg_total else "")] = dev
        out[tag] = rec
        tables.append(f"== {tag} ({'1 trip' if res.n_cg_total else 'full'}) | {card}\n"
                      + prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        print(json.dumps({tag: rec}), flush=True)
    cfg4 = FootingConfig.fast(level=4, solver="cg", assembled_cg=True, cg_maxiter=4000,
                              max_trips=2)
    t0 = time.perf_counter()
    run4, mesh4 = footing.build_df32(cfg4, device=device)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    spmv.LAUNCHES.clear()
    t0 = time.perf_counter()
    res = run4()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    out["footing_df32_acg_L4_2_trips"] = rec = dict(
        unknowns=int(mesh4.free.sum()), setup_s=setup, wall_s=wall,
        counts=[res.n_steps, res.n_newton_total, res.n_cg_total, res.n_plastic],
        last_pressure=float(res.pressure_hist[res.n_steps]),
        kernel_launches_by_name=dict(spmv.LAUNCHES),
        cg_iteration_us=1e6 * wall / res.n_cg_total,
    )
    print(json.dumps({"footing_df32_acg_L4_2_trips": rec}), flush=True)
    return out


def footing_scale_runs(torch, profile, activities, device, card, tables, levels) -> dict:
    """The `--footing-scale` measurements (module doc)."""
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
    from fem_elastoplasticity_tpu_torch.ops import spmv
    from fem_elastoplasticity_tpu_torch.utils.convert import load_checkpoint

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    out = {}
    for level in levels:
        tag = f"footing_scale_L{level}"
        cfg = FootingConfig.fast_scale(level, max_trips=1 if level >= 5 else 3)
        (run, mesh), setup = timed(lambda: footing.build_df32(cfg, device=device))
        resume, profiled_run = None, run
        if level >= 5:
            resume = load_checkpoint(ROOT / "checkpoints" / "footing_l5_k16.npz", device=device)
            cut, _ = footing.build_df32(dataclasses.replace(cfg, newton_maxit=3), device=device)
            profiled_run = lambda: cut(resume=resume)  # noqa: E731
        base_newton = resume["nits_total"] if resume else 0
        base_cg = resume["ncg_total"] if resume else 0
        spmv.LAUNCHES.clear()
        res, first = timed(lambda: run(resume=resume))
        launches = dict(spmv.LAUNCHES)
        walls = [timed(lambda: run(resume=resume))[1] for _ in range(2)]
        n_newton, n_cg = res.n_newton_total - base_newton, res.n_cg_total - base_cg
        rec = dict(
            unknowns=int(mesh.free.sum()), setup_s=setup, wall_first_s=first, walls_s=walls,
            counts=dict(steps=res.n_steps, newton=n_newton, cg=n_cg, plastic=res.n_plastic),
            newton_trips=list(res.newton_trips), zeta_trips=list(res.zeta_trips),
            cg_iteration_ms=1e3 * min(walls) / n_cg, kernel_launches_by_name=launches,
        )
        pres, wall_p, prof = profiled(torch, profile, activities, profiled_run)
        dev = device_summary(prof, wall_p)
        p_cg = pres.n_cg_total - base_cg
        host = [e for e in prof.events() if e.device_type.name != "CUDA"]
        dev.update(
            profiled_cg=p_cg,
            device_kernels_per_cg_iteration=dev["kernel_launches"] / p_cg,
            host_scalar_reads_per_cg_iteration=dev["host_scalar_reads"] / p_cg,
            stream_syncs_per_cg_iteration=sum(
                e.name == "cudaStreamSynchronize" for e in host) / p_cg,
        )
        rec["profiled_run"] = dev
        out[tag] = rec
        tables.append(f"== {tag} | {card}\n"
                      + prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
        print(json.dumps({tag: rec}), flush=True)
        del run, profiled_run
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="profile_port_solve.txt")
    ap.add_argument("--scale", type=int, nargs="*", default=[], metavar="L")
    ap.add_argument("--ell", type=int, nargs="*", default=[], metavar="L")
    ap.add_argument("--no-dense", action="store_true")
    ap.add_argument("--footing", action="store_true")
    ap.add_argument("--footing-scale", type=int, nargs="*", default=[], metavar="L")
    ap.add_argument("--high-order", action="store_true")
    opts = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port_solve: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.ops import spmv
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType
    from fem_elastoplasticity_tpu_torch.utils.precision import resolve_device

    device = resolve_device("cuda")
    activities = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tables, summary = [], {"card": card}
    runs, setup_s = {}, {}
    if not opts.no_dense:
        bench_run, _ = tsx.build_df32(TsxTunnelConfig.fast(assembled_cg=True), device=device)
        runs = {
            "f64": lambda: tsx.solve(TsxTunnelConfig(), device=device),
            "bench": bench_run,
            "tsx_f32": lambda: tsx.solve(TsxTunnelConfig.fast_f32(), device=device),
            "footing_f64": lambda: footing.solve(FootingConfig(), device=device),
            "footing_f32": lambda: footing.solve(FootingConfig.fast_f32(), device=device),
        }
    scale = [(f"scale_L{L}", TsxTunnelConfig.fast_scale(L)) for L in opts.scale] + [
        (f"ell_L{L}", TsxTunnelConfig.fast_scale(L, spmv_fmt="ell", corr_mode="gather",
                                                 residual_fmt="ell")) for L in opts.ell]
    if opts.high_order:
        scale += [(f"{et}_refine{L}_pmg", TsxTunnelConfig.fast(
            etype=ElementType[et], solver="ell", refine_levels=L))
            for et, L in (("P4", 0), ("P4", 2), ("P2", 3))]
    peak_gib = {}
    for tag, cfg in scale:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        run, _ = tsx.build_df32(cfg, device=device)
        torch.cuda.synchronize()
        setup_s[tag] = time.perf_counter() - t0
        runs[tag] = run
        run()  # the peak of setup and a run
        torch.cuda.synchronize()
        peak_gib[tag] = (torch.cuda.max_memory_allocated() - held) / 2**30
    for tag, run in runs.items():
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        spmv.LAUNCHES.clear()
        res, wall_prof, prof = profiled(torch, profile, activities, run)
        summary[tag] = dict(wall_first_s=first, walls_s=walls, **device_summary(prof, wall_prof))
        if tag in setup_s:
            host = [e for e in prof.events() if e.device_type.name != "CUDA"]
            reads = summary[tag]["host_scalar_reads"]
            syncs = sum(e.name == "cudaStreamSynchronize" for e in host)
            n_cg = int(res.n_cg_total)
            summary[tag].update(
                setup_s=setup_s[tag],
                peak_memory_gib=peak_gib[tag],
                counts=dict(steps=int(res.n_steps), newton=int(res.n_newton_total), cg=n_cg,
                            plastic=int(res.n_plastic)),
                kernel_launches_by_name=dict(spmv.LAUNCHES),
                host_scalar_reads=reads,
                stream_syncs=syncs,
                host_scalar_reads_per_cg_iteration=reads / n_cg,
                stream_syncs_per_cg_iteration=syncs / n_cg,
                device_kernels_per_cg_iteration=summary[tag]["kernel_launches"] / n_cg,
            )
        tables.append(f"== {tag} | {card}\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    if opts.footing:
        summary["footing"] = footing_runs(torch, profile, activities, device, card, tables)
    if opts.footing_scale:
        summary["footing_scale"] = footing_scale_runs(torch, profile, activities, device, card,
                                                      tables, opts.footing_scale)
    out = pathlib.Path(opts.out)
    out.write_text("\n\n".join(tables))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
