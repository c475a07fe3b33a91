#!/usr/bin/env python3
"""Run `chip_smoke.py`'s phase 29 on the card with all five high-order
routes: P2 at the full schedule and P4 cut at zeta 12/17 on the native,
matrix-free and assembled block-Jacobi routes and p-multigrid with and
without gs_tangent, each against its JAX run (the smoke keeps the
p-multigrid routes only), and print their launches as one JSON line.
About 100 s on an H100.

    python tools/high_order_plastic.py
"""
from __future__ import annotations

import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ROUTES = ("native", "cg", "acg", "pmg_gs", "pmg_mf")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("high_order_plastic: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.ops import spmv
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType
    from fem_elastoplasticity_tpu_torch.utils.precision import resolve_device

    t0 = time.perf_counter()
    device = resolve_device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    for load in (spmv.load_kernel, spmv.load_sweep_kernel, spmv.load_transfer_kernel):
        load()
    launches = cs.high_order_plastic_phase(torch, spmv, tsx, TsxTunnelConfig, ElementType,
                                           device, card, routes=ROUTES)
    print(f"total {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    print(json.dumps({"card": card, "launches": launches}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
