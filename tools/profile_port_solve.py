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

    python tools/profile_port_solve.py [OUT] [--scale L ...] [--ell L ...] [--no-dense]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out", nargs="?", default="profile_port_solve.txt")
    ap.add_argument("--scale", type=int, nargs="*", default=[], metavar="L")
    ap.add_argument("--ell", type=int, nargs="*", default=[], metavar="L")
    ap.add_argument("--no-dense", action="store_true")
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
    from fem_elastoplasticity_tpu_torch.utils.precision import resolve_device

    device = resolve_device("cuda")
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
    for tag, cfg in scale:
        t0 = time.perf_counter()
        run, _ = tsx.build_df32(cfg, device=device)
        torch.cuda.synchronize()
        setup_s[tag] = time.perf_counter() - t0
        runs[tag] = run
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
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            res = run()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy_us = sum(e.device_time_total for e in kernels)
        top = {}
        for e in kernels:
            top[e.name] = top.get(e.name, 0.0) + e.device_time_total
        top = sorted(top.items(), key=lambda kv: -kv[1])[:8]
        summary[tag] = dict(
            wall_first_s=first,
            walls_s=walls,
            wall_profiled_s=wall_prof,
            device_busy_s=busy_us * 1e-6,
            device_idle_share=1.0 - busy_us * 1e-6 / wall_prof,
            kernel_launches=len(kernels),
            top_kernels_ms={k[:80]: v * 1e-3 for k, v in top},
        )
        if tag in setup_s:
            host = [e for e in prof.events() if e.device_type.name != "CUDA"]
            reads = sum(e.name == "aten::_local_scalar_dense" for e in host)
            syncs = sum(e.name == "cudaStreamSynchronize" for e in host)
            n_cg = int(res.n_cg_total)
            summary[tag].update(
                setup_s=setup_s[tag],
                counts=dict(steps=int(res.n_steps), newton=int(res.n_newton_total), cg=n_cg,
                            plastic=int(res.n_plastic)),
                kernel_launches_by_name=dict(spmv.LAUNCHES),
                host_scalar_reads=reads,
                stream_syncs=syncs,
                host_scalar_reads_per_cg_iteration=reads / n_cg,
                stream_syncs_per_cg_iteration=syncs / n_cg,
                device_kernels_per_cg_iteration=len(kernels) / n_cg,
            )
        tables.append(f"== {tag} | {card}\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    out = pathlib.Path(opts.out)
    out.write_text("\n\n".join(tables))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
