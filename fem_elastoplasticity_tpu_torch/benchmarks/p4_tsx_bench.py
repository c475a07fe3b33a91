"""Full-schedule P4 TSX excavation benchmark (the reference's entry point).

Port of `fem_elastoplasticity_tpu/benchmarks/p4_tsx_bench.py`.  The
reference's own configuration is `elasticity_fem(P4, level=1)`
(`tsx-tunnel/sandbox.py:4`, `tsx-tunnel/pythonFEM.py:1637`): 15-node
quartic triangles on the unstructured tunnel mesh, full excavation to
zeta = 1.  This runs it end to end and reports the wall and the
trajectory's facts.

Routes: the default `TsxTunnelConfig.fast(etype=P4, solver="ell")` is
p-multigrid: the P4 node lattice equals two red refinements of the base
mesh, so the assembled P1 hierarchy preconditions the high-order tangent
CG (K1 for the f64 residual, K3's CSR kernel on the f32 heads of G and S,
K3's transfers and K4 in the V-cycle); `--mf` runs matrix-free block-Jacobi
CG (`solver="cg"`), `--assembled` the assembled tangent
(`solver="cg", assembled_cg=True`: K3's node-block product and K1); `--native`
runs `TsxTunnelConfig(etype=P4, solver="cg")` in f64 through `solve`.

The df32 routes build once (`build_df32`, host setup, not timed) and run
twice: `cold_incl_compile_s` is the first run (it pays the kernels' loads
and the caching allocator's first requests), `value` the second.  Each
wall ends in `utils.timing.host_sync` of the result.

    python -m fem_elastoplasticity_tpu_torch.benchmarks.p4_tsx_bench [--mf | --assembled] \\
        [--native] [--cpu]
"""
from __future__ import annotations

import json
import time

from ..models import tsx_tunnel as tsx
from ..models.config import TsxTunnelConfig
from ..ops.elements import ElementType
from ..utils.precision import resolve_device
from ..utils.timing import host_sync


def main(fast: bool = True, solver: str = "ell", device=None) -> dict:
    """Print and return the record of one route (module docstring)."""
    device = resolve_device(device)
    if fast:
        kw = dict(etype=ElementType.P4, solver=solver)
        if solver == "cg-assembled":
            kw = dict(etype=ElementType.P4, solver="cg", assembled_cg=True)
        cfg = TsxTunnelConfig.fast(**kw)
    else:
        cfg = TsxTunnelConfig(etype=ElementType.P4, solver="cg")
    if fast:
        # the built runner: the warm wall excludes host setup
        run, _ = tsx.build_df32(cfg, device=device)
        t0 = time.perf_counter()
        res = run()
        host_sync(res.u)
        wall = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = run()
        host_sync(res.u)
        warm = time.perf_counter() - t0
        facts = dict(
            n_steps=int(res.n_steps),
            n_newton_total=int(res.n_newton_total),
            n_plastic=int(res.n_plastic),
            u40=float(res.monitor_hist[int(res.n_steps) - 1]),
            n_cg_total=int(res.n_cg_total),
        )
    else:
        t0 = time.perf_counter()
        r = tsx.solve(cfg, device=device)
        warm = wall = time.perf_counter() - t0
        facts = dict(
            n_steps=r.n_steps,
            n_newton_total=r.n_newton_total,
            n_plastic=r.n_plastic,
            u40=float(r.u[40, 0]),
            n_cg_total=r.n_cg_total,
        )

    path = f"df32_{solver}" if fast else "native_cg"
    rec = {
        "metric": "tsx_tunnel_p4_full_schedule_wall",
        "value": warm,
        "unit": "s",
        "cold_incl_compile_s": wall,
        "path": path,
        **facts,
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    import sys

    solver = "ell"
    if "--mf" in sys.argv:
        solver = "cg"
    elif "--assembled" in sys.argv:
        solver = "cg-assembled"
    main(fast="--native" not in sys.argv, solver=solver,
         device="cpu" if "--cpu" in sys.argv else None)
