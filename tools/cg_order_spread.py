"""How the CG count of one tsx route moves with the order of its sums.

Runs one route of the high-order fixtures that `tools/make_port_fixtures.py`
writes (default `tsx_p4_cg_z1`: P4 elements, the matrix-free df32 route,
cut at zeta 1/17) on the same mesh with its elements listed in N orders:
the mesh's own (order 0) and N - 1 seeded permutations.  The problem is
the same, so u agrees to the rounding level; what changes is the order in
which the matrix-free products add each node's element contributions, so
the f32 products round differently.  For each order it prints the step,
Newton and CG counts and u's distance to the fixture's, then one JSON line
with the counts and the card's name and power limit.

    python tools/cg_order_spread.py [--fixture NAME] [--orders N] [--device cuda|cpu]
                                    [--threads T]
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
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--fixture", default="tsx_p4_cg_z1")
    ap.add_argument("--orders", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--threads", type=int, default=0, help="CPU threads (0: torch's default)")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType

    if args.threads:
        torch.set_num_threads(args.threads)
    want = np.load(FIXTURES / f"{args.fixture}.npz")
    c = json.loads(want["config"].item())
    kw = {k: v for k, v in c.items() if k not in ("etype", "steps", "route")}
    cfg = TsxTunnelConfig(etype=ElementType[c["etype"]], zeta_max=c["steps"] / 17, **kw)
    if args.device == "cuda":
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True).stdout.strip().splitlines()[0]
    else:
        card = f"CPU, {torch.get_num_threads()} threads"
    own_mesh = tsx.tsx_mesh
    rows = []
    for k in range(args.orders):
        perm = (np.arange if k == 0 else np.random.default_rng(k).permutation)(
            own_mesh(cfg.etype, cfg.refine_levels).elems.shape[0])
        # the route builds its mesh through tsx_mesh: hand it the same mesh
        # with its elements in this order
        tsx.tsx_mesh = lambda et, lv, perm=perm: dataclasses.replace(
            own_mesh(et, lv), elems=own_mesh(et, lv).elems[perm])
        t0 = time.perf_counter()
        if cfg.precision == "native":
            r = tsx.solve(cfg, device=args.device)
        else:
            run, mesh = tsx.build_df32(cfg, device=args.device, extras=(extras := {}))
            r = tsx._df32_result(run(), mesh, extras)
        wall = time.perf_counter() - t0
        u_rel = float(np.abs(r.u - want["u"]).max() / np.abs(want["u"]).max())
        rows.append(dict(order=k, steps=r.n_steps, newton=r.n_newton_total, cg=r.n_cg_total,
                         plastic=r.n_plastic, u_rel=u_rel))
        print(f"{args.fixture} element order {k}: steps / Newton / CG / plastic "
              f"{(r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic)}, u {u_rel:.3e} from "
              f"JAX's, {wall:.2f} s | {card}", flush=True)
    tsx.tsx_mesh = own_mesh
    cgs = [row["cg"] for row in rows]
    print(json.dumps({"fixture": args.fixture, "device": args.device, "card": card,
                      "jax_cg": int(want["n_cg_total"]), "cg_min": min(cgs),
                      "cg_max": max(cgs), "orders": rows}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
