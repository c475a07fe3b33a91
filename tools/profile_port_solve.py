"""Profile the PyTorch port's solves on one CUDA card.

The solves: tsx native f64, the tsx bench preset (df32), tsx `fast_f32`
(kernel K2), and the footing in native f64 and `fast_f32` (K2).  Runs each
solve once to warm up, five times on the host clock, then once under
`torch.profiler`, and reports the host wall, the device busy time (sum of
kernel times on the one stream the solver uses), the device idle share, the
kernel launch count and the kernels that take the most device time.  Writes the profiler tables to
OUT (default `profile_port_solve.txt`) and prints one JSON summary line.

    python tools/profile_port_solve.py [OUT]
"""
from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("profile_port_solve: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.utils.precision import resolve_device

    device = resolve_device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    tables, summary = [], {"card": card}
    bench_run, _ = tsx.build_df32(TsxTunnelConfig.fast(assembled_cg=True), device=device)
    runs = {
        "f64": lambda: tsx.solve(TsxTunnelConfig(), device=device),
        "bench": bench_run,
        "tsx_f32": lambda: tsx.solve(TsxTunnelConfig.fast_f32(), device=device),
        "footing_f64": lambda: footing.solve(FootingConfig(), device=device),
        "footing_f32": lambda: footing.solve(FootingConfig.fast_f32(), device=device),
    }
    for tag, run in runs.items():
        run()
        torch.cuda.synchronize()
        walls = []
        for _ in range(5):
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_prof = time.perf_counter() - t0
        kernels = [e for e in prof.events() if e.device_type.name == "CUDA"]
        busy_us = sum(e.device_time_total for e in kernels)
        top = {}
        for e in kernels:
            top[e.name] = top.get(e.name, 0.0) + e.device_time_total
        top = sorted(top.items(), key=lambda kv: -kv[1])[:8]
        summary[tag] = dict(
            walls_s=walls,
            wall_profiled_s=wall_prof,
            device_busy_s=busy_us * 1e-6,
            device_idle_share=1.0 - busy_us * 1e-6 / wall_prof,
            kernel_launches=len(kernels),
            top_kernels_ms={k[:80]: v * 1e-3 for k, v in top},
        )
        tables.append(f"== {tag} | {card}\n" + prof.key_averages().table(
            sort_by="self_device_time_total", row_limit=40))
    out = pathlib.Path(sys.argv[1] if len(sys.argv) > 1 else "profile_port_solve.txt")
    out.write_text("\n\n".join(tables))
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
