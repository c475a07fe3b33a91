"""The readings that the limits of a cell's check are set from.

    python3 -m port_bench.calibrate --workload <name> --seeds <n> [<n> ...]

In one process: the port's solver for the cell's mix, then for each seed
one request through the timed entry at the cell's own size (every request
of a mix is the same solve: the seed picks only the checked answer in a
run), and the compared numbers of its answer (`reference/compare.py`),
beside those of the control: the same answer rounded to float32, the best
a solver that keeps its state in float32 could hand back.  Where the entry
splits a request (`harness` module doc), its split run is made once and
the state a trip short of the end is judged too.  One JSON line a seed.
The lower reading of a number is the largest the port gives over the
seeds, the upper the smallest the control gives; the limit lies between
them (`checks/<workload>.json`).
Needs a CUDA card, as the benchmark's runs do.
"""
from __future__ import annotations

import argparse
import importlib
import json
import pathlib
import sys
import time

import torch

from port_bench import harness
from port_bench import traffic as traffic_gen
from port_bench.reference import compare

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(root: pathlib.Path, workload: str, seeds, device: torch.device):
    """Yield one record a seed: counts, wall, the port's and the control's
    numbers (and, once, those of the split run's state a trip short)."""
    spec = harness.load(root, workload)
    config = spec["config"]
    material = traffic_gen.material(spec["traffic"])
    entry = importlib.import_module(f"port_bench.entries.{config['entry']}")
    ref = importlib.import_module(f"port_bench.reference.{config['reference']}")
    problem = ref.Problem(config, material, root)
    solver = entry.build(config, material, root, device)
    mapped = compare.Mapped(problem, *solver.layout)
    split = None
    for seed in seeds:
        t0 = time.perf_counter()
        raw = solver.request()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
        answer, counts = solver.answer(raw), solver.counts(raw)
        del raw
        rec = {"seed": seed, "counts": counts, "wall_s": wall}
        if hasattr(entry, "split") and split is None:
            split = entry.split(config, material, root, device, answer)
            rec["before"] = compare.numbers(problem, mapped, split["before"], final=False)
        start = split["before"]["ep"] if split else problem.start()
        low = compare.control(answer)
        rec["port"] = compare.numbers(problem, mapped, answer, start)
        rec["control"] = compare.numbers(problem, mapped, low, start)
        if split:
            rec["port"]["resume_gap"] = compare.resume_gap(split["resumed"], answer)
            rec["control"]["resume_gap"] = compare.resume_gap(split["resumed"], low)
        yield rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card visible", file=sys.stderr)
        return 3
    for rec in readings(ROOT, args.workload, args.seeds, torch.device("cuda:0")):
        print(json.dumps(rec), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
