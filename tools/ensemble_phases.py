#!/usr/bin/env python3
"""Run `chip_smoke.py`'s ensemble phases alone on the card: phase 32 (K2's
member-batched instance against its plain version and 64 single launches)
and phase 33 (the four 64-member ensembles against their members' single
solves), and print their numbers as one JSON line (to FILE too with --out).

With --all-singles the CG ensemble (refine 1) is held against all 64 single
solves, not the smoke's eight (about 8 min more on an H100).

    python tools/ensemble_phases.py [--all-singles] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--all-singles", action="store_true")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ensemble_phases: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.ops import return_map as rm
    from fem_elastoplasticity_tpu_torch.utils.precision import resolve_device

    t0 = time.perf_counter()
    device = resolve_device("cuda")
    card = cs.card_line()
    print(card, flush=True)
    rm.load_kernel()
    shapes, err = cs.k2_batched_phase(torch, rm, device, card)
    runs, k2, _ = cs.ensemble_phase(torch, tsx, TsxTunnelConfig, device, card,
                                    all_singles=args.all_singles)
    line = json.dumps({"card": card, "k2_batched": shapes, "k2_batched_max_abs_err": err,
                       "ensembles": runs, "f32_k2_launches": k2})
    if args.out is not None:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(line + "\n")
    print(f"total {time.perf_counter() - t0:.1f} s | {card}", flush=True)
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
