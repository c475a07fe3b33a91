#!/usr/bin/env python3
"""Where the port's footing df32 CG schedules part from the JAX package's.

Runs a footing configuration through the PyTorch port on the CPU and holds
it load trip by load trip against the JAX package's run of the same
configuration, read from its fixture (`tools/make_port_fixtures.py`
`footing_df32_cg_full`, `footing_df32_acg_full`: per trip the Newton and CG
iterations, zeta after the trip and whether it accepted a step).  Prints
both runs side by side, the port's CG iterations per Newton iteration with
the solves that hit cg_maxiter marked, and the first trip where the runs
part: a Newton count outside `footing.newton_trip_gaps`' rule, another zeta
after the trip, or a step accepted in one run and rejected in the other.
Trips that differ only by the two-float criterion floor, class (a), are
within the rule and do not part.  The parting trip is put in a class:

  (b) a CG solve at that trip hit cg_maxiter in the JAX run at a Newton
      iteration where the port's solve converged or that the port never
      ran, every trip before it within the rule: a capped solve forked the
      step control (its Newton counts may still obey the floor rule);
  (c) otherwise: a fault of the port.

Usage (from the repository root; about 70 s and 90 s on the CPU):

    python tools/port_footing_trips.py [cg|acg ...] [--max-trips N]
"""
from __future__ import annotations

import argparse
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
ZETA_TOL = 1e-12

SCHEDULES = {
    "cg": ("footing_df32_cg_full", dict(solver="cg")),
    "acg": ("footing_df32_acg_full", dict(solver="cg", assembled_cg=True, cg_maxiter=4000)),
}


def jax_trips(name: str) -> dict:
    """The JAX run's per-trip record and, where the fixture has it, the CG
    iterations of the first `probe_newton` Newton iterations of trip
    `probe_trip`."""
    import numpy as np

    f = np.load(FIXTURES / f"{name}.npz")
    return {k: f[k] for k in f.files}


def compare(r, ref: dict, cfg) -> list:
    """[(trip, what differs), ...] over the trips both runs have, 1-based."""
    from fem_elastoplasticity_tpu_torch.models import footing

    n = min(len(r.newton_trips), len(ref["newton_trips"]))
    cut = r._replace(newton_trips=r.newton_trips[:n], crit_trips=r.crit_trips[:n])
    gaps = {g[0] for g in footing.newton_trip_gaps(cut, ref["newton_trips"][:n], cfg)}
    out = []
    for i in range(n):
        what = []
        if i + 1 in gaps:
            what.append("Newton count outside the rule")
        if abs(r.zeta_trips[i] - float(ref["zeta_trips"][i])) > ZETA_TOL:
            what.append("zeta after the trip")
        accepted = not (r.crit_trips[i] != r.crit_trips[i]) and r.crit_trips[i] < cfg.accept_tol
        if accepted != bool(ref["accepted_trips"][i]):
            what.append("accepted in one run only")
        if what:
            out.append((i + 1, ", ".join(what)))
    return out


def jax_capped_at(ref: dict, trip: int, cg_maxiter: int):
    """The Newton iteration (1-based) whose CG solve hit cg_maxiter and
    ended the JAX run's trip `trip`, as far as its record shows: a
    one-iteration trip of cg_maxiter CG iterations, or the fixture's probe
    of the trip's earlier iterations leaving cg_maxiter for the last one.
    0 when the record shows no capped solve, None when it cannot tell."""
    i = trip - 1
    nits, cg = int(ref["newton_trips"][i]), int(ref["cg_trips"][i])
    if nits == 1:
        return 1 if cg == cg_maxiter else 0
    if "probe_trip" in ref and int(ref["probe_trip"]) == trip and int(ref["probe_newton"]) == nits - 1:
        return nits if cg - int(ref["probe_cg"]) == cg_maxiter else 0
    return None


def report(tag: str, max_trips: int) -> int:
    sys.path.insert(0, str(ROOT))
    import torch

    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig

    torch.set_num_threads(1)
    name, kw = SCHEDULES[tag]
    cfg = FootingConfig.fast(**kw, max_trips=max_trips)
    ref = jax_trips(name)
    t0 = time.perf_counter()
    r = footing.solve(cfg, device="cpu")
    wall = time.perf_counter() - t0
    print(f"== {tag}: FootingConfig.fast({', '.join(f'{k}={v!r}' for k, v in kw.items())}), "
          f"port on the CPU {wall:.1f} s, one thread")
    print(f"   port {r.n_steps} steps / {r.n_newton_total} Newton / {r.n_cg_total} CG / "
          f"{r.n_plastic} plastic; JAX {int(ref['n_steps'])} / {int(ref['n_newton_total'])} / "
          f"{int(ref['n_cg_total'])} / {int(ref['n_plastic'])}")
    print("   trip | JAX: Newton CG acc zeta | port: Newton CG acc zeta last-criterion | "
          "port CG a Newton iteration (* hit cg_maxiter)")
    n = max(len(r.newton_trips), len(ref["newton_trips"]))
    for i in range(n):
        j = (f"{int(ref['newton_trips'][i]):3d} {int(ref['cg_trips'][i]):6d} "
             f"{int(ref['accepted_trips'][i])} {float(ref['zeta_trips'][i]):.6f}"
             if i < len(ref["newton_trips"]) else " " * 24)
        if i < len(r.newton_trips):
            crit = r.crit_trips[i]
            acc = int(crit == crit and crit < cfg.accept_tol)
            solves = " ".join(f"{k}{'' if ok else '*'}" for k, ok in r.cg_trips[i])
            p = (f"{r.newton_trips[i]:3d} {sum(k for k, _ in r.cg_trips[i]):6d} {acc} "
                 f"{r.zeta_trips[i]:.6f} {crit:.3e} | {solves}")
        else:
            p = ""
        print(f"   {i + 1:4d} | {j} | {p}")
    parts = compare(r, ref, cfg)
    if not parts:
        print(f"   no trip parts over the {min(n, len(r.newton_trips))} trips both runs have")
        return 0
    trip, what = parts[0]
    i = trip - 1
    solves = r.cg_trips[i]
    port_capped = next((m + 1 for m, (_, ok) in enumerate(solves) if not ok), 0)
    capped = jax_capped_at(ref, trip, cfg.cg_maxiter)
    floor = "Newton" not in what  # the trip's Newton counts obey the rule
    unequal = [k + 1 for k in range(i) if r.newton_trips[k] != int(ref["newton_trips"][k])]
    # (b): one run's solve hit the cap at a Newton iteration where the
    # other run's solve converged or that it never ran
    fork = bool(capped) and (capped > len(solves) or solves[capped - 1][1])
    if fork:
        cls = "(b) a capped CG solve forks the step control" + (
            ", after a floor iteration (a) of the JAX run" if floor else "")
    else:  # a trip within the floor rule alone does not part
        cls = "(c) a fault of the port"
    print(f"   first parting trip: {trip} ({what}); capped CG solve at Newton iteration: JAX "
          f"{capped}, port {port_capped} (0: none); its Newton counts within the floor rule: "
          f"{floor}")
    print(f"   trips before it: zeta and accept/reject equal, Newton counts equal but on trips "
          f"{unequal} (within the floor rule); class {cls}")
    return trip


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("tags", nargs="*", help=f"schedules among {list(SCHEDULES)} (default: all)")
    ap.add_argument("--max-trips", type=int, default=10000)
    args = ap.parse_args(argv)
    unknown = set(args.tags) - set(SCHEDULES)
    if unknown:
        ap.error(f"unknown schedules {sorted(unknown)}")
    for tag in args.tags or SCHEDULES:
        report(tag, args.max_trips)
    return 0


if __name__ == "__main__":
    sys.exit(main())
