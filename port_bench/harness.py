"""The run of one cell: set-up, the measured window, the check.

Everything a cell needs is found by name from `BENCHMARK.json` at `root`:
its configuration (`configs/<name>.json`, whose "entry" names the module
of `entries/` that drives the port and whose "reference" names the module
of `reference/` that judges it), its traffic (`traffic/<name>.json`), its
limits (`checks/<workload>.json`) and its metrics (`metrics/<name>.py`).

1. Set-up: the entry builds the port's solver for the mix's material, then
   one warm request, which also takes the CUDA context; `setup_s` runs from
   the process's start to the end of that request.
2. Window: requests back to back, each ended by a device sync; no request
   starts once `seconds` have passed since the first started.  With
   `trace`, or where a metric of the run reads the profile (`PROFILED`,
   as `device_s` does), one whole request under the profiler follows (the
   traced window): the profiler slows the process for a while after it
   stops.  On a card, a run that wants the profile and loses the device's
   activity in it twice raises `TraceError`.
   In a traced run on a card, a span that a metric names must exist in the
   port and have device work launched inside it, and each of the cell's
   per-layer metrics must read a number: else `TraceError`.
3. Check, outside every timed part: the peak memory is read, the port's
   state freed, and a sample of the answers (the last, and one other drawn
   from the seed) compared with the reference on the host.  Where the
   entry has a `split` (the state before a request's last load trip lies
   on a path the reference does not re-run), the port's solver is built
   anew to stop a trip short and resumed from there: the resumed answer
   must equal the timed ones bit for bit, the state a trip short is judged
   by itself, and the timed answers' return map is held to the reference's
   from it.
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import pathlib
import time

import numpy as np
import torch

from port_bench import trace as tracing
from port_bench import traffic as traffic_gen
from port_bench.reference import compare

PKG = "port_bench"


def load(root: pathlib.Path, workload: str) -> dict:
    """The cell's entries of BENCHMARK.json and its files, by name."""
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if cell is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == cell["config"])
    base = root / PKG
    return {
        "bench": bench, "cell": cell,
        "config": json.loads((root / conf["file"]).read_text()),
        "traffic": json.loads((base / "traffic" / f"{cell['traffic']}.json").read_text()),
        "checks": json.loads((base / "checks" / f"{workload}.json").read_text()),
    }


def metric_names(bench: dict, workload: str, traced: bool) -> list:
    group = bench["per_layer" if traced else "end_to_end"]
    return [m["name"] for m in group if workload in m.get("workloads", [workload])]


def reader(name: str):
    """The metric's reader: `metrics/<name>.py` (dots and dashes as
    underscores), else that of the name before its first dot, so that one
    quantity split by the end-to-end metric it moves (`idle_share.tsx`)
    keeps one reader."""
    for n in (name, name.split(".")[0]):
        mod = f"{PKG}.metrics.{n.replace('.', '_').replace('-', '_')}"
        if importlib.util.find_spec(mod) is not None:
            return importlib.import_module(mod)
    raise ModuleNotFoundError(f"no reader for metric {name!r}")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Sampler:
    """The last answer and one other drawn uniformly (reservoir of one)."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng([int(seed), 1])
        self.last = self.kept = None
        self.seen = 0

    def add(self, raw) -> None:
        if self.last is not None:
            self.seen += 1
            if self.rng.random() * self.seen < 1.0:
                self.kept = self.last
        self.last = raw

    def sample(self) -> list:
        return [r for r in (self.kept, self.last) if r is not None]


def run_cell(root: pathlib.Path, workload: str, seed: int, seconds: float, traced: bool,
             device: torch.device, t_process: float, log) -> dict:
    """One run of `workload`: the result line's object (module doc).  `log`
    is a callable taking one line for standard error."""
    spec = load(root, workload)
    bench, config, checks = spec["bench"], spec["config"], spec["checks"]
    names = metric_names(bench, workload, traced)
    readers = {n: reader(n) for n in names}
    material = traffic_gen.material(spec["traffic"])
    log(f"material {json.dumps(material)}")
    entry = importlib.import_module(f"{PKG}.entries.{config['entry']}")

    # 1. set-up
    solver = entry.build(config, material, root, device)
    raw = solver.request()
    _sync(device)
    setup_s = time.time() - t_process
    warm = solver.counts(raw)
    log(f"set-up {setup_s:.3f} s (build {solver.build_s:.3f} s); warm request {json.dumps(warm)}")
    del raw
    sampler = Sampler(seed)
    attempted = failed = 0
    run: dict = {"setup_s": setup_s, "build_s": solver.build_s, "traced": None}

    # 2. the window, then (trace) one whole request under the profiler, which
    # leaves the process slower for a while: the window comes first
    trace = None
    counts, walls = [], []
    t_first = t_last = None
    try:
        while t_first is None or time.perf_counter() - t_first < seconds:
            t0 = time.perf_counter()
            t_first = t0 if t_first is None else t_first
            attempted += 1
            raw = solver.request()
            _sync(device)
            t_last = time.perf_counter()
            walls.append(t_last - t0)
            counts.append(solver.counts(raw))
            sampler.add(raw)
            del raw
        if traced or any(getattr(r, "PROFILED", False) for r in readers.values()):
            spans = [s for r in readers.values() for s in getattr(r, "SPANS", ())]
            tracing.traced(lambda: torch.zeros(1, device=device), 1, device)  # profiler start-up
            # one whole request; a second where the profiler lost the first's
            # device activity
            for _ in range(2 if device.type == "cuda" else 1):
                attempted += 1
                t0 = time.perf_counter()
                raws, trace = tracing.traced(solver.request, 1, device, spans)
                log(f"traced request and its reading: {time.perf_counter() - t0:.3f} s")
                for r in raws:
                    sampler.add(r)
                if trace is not None:
                    run["traced"] = {"counts": [solver.counts(r) for r in raws]}
                    log(f"traced request: wall {trace.wall_s:.4f} s, busy {trace.busy_s:.4f} s, "
                        f"{len(trace.ops)} device ops, {trace.host_reads} host reads")
                    break
                if device.type == "cuda":
                    log("the profile lost the device's activity")
            del raws
    except tracing.TraceError:
        raise
    except Exception as exc:  # a request that raised: the run reports it and is not correct
        failed += 1
        log(f"request {attempted} raised {type(exc).__name__}: {exc}")
    if device.type == "cuda" and run["traced"] is None and attempted > len(walls) and not failed:
        raise tracing.TraceError("the profile lost the device's activity twice")
    if trace is not None:
        for name, r in readers.items():
            sites = tracing.sites(getattr(r, "SPANS", ()))
            if sites and not trace.launches_in(sites):
                raise tracing.TraceError(f"{name}: no device work was launched inside "
                                         f"{', '.join(sorted(sites))}")
    run["window"] = {"requests": len(walls), "counts": counts,
                     "seconds": (t_last - t_first) if walls else 0.0}
    log(f"window: {len(walls)} requests in {run['window']['seconds']:.4f} s; walls "
        f"{json.dumps([round(w, 6) for w in walls])}; counts {json.dumps(counts[:1])}")
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    # 3. the check, on the host, after the port's state is freed
    answers = [solver.answer(r) for r in sampler.sample()]
    layout = solver.layout
    del sampler, solver
    _free(device)
    t0 = time.perf_counter()
    split = None
    if hasattr(entry, "split") and answers and not failed:
        try:
            split = entry.split(config, material, root, device, answers[-1])
        except Exception as exc:  # the check then lacks the numbers it needs
            log(f"split run raised {type(exc).__name__}: {exc}")
        _free(device)
    numbers = judge(root, config, material, layout, answers, split, log) if not failed else {}
    log(f"check of {len(answers)} answers{' and the split run' if split else ''}: "
        f"{time.perf_counter() - t0:.3f} s")
    limits = checks["limits"]
    correct = bool(answers) and not failed and all(
        k in numbers and numbers[k] <= lim for k, lim in limits.items())

    metrics = {}
    units = {m["name"]: m["unit"] for m in bench["end_to_end"] + bench["per_layer"]}
    for name in names:
        value = readers[name].read(run, trace)
        if value is not None:
            metrics[name] = {"value": float(value), "unit": units[name]}
        elif trace is not None:
            raise tracing.TraceError(f"{name}: its reader found nothing in the trace")
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": int(spec["cell"]["chips"]), "memory_peak_bytes": int(peak)}
    out = {"correct": correct, "attempted": attempted, "failed": failed, "metrics": metrics,
           "device": dev}
    if traced and trace is not None:
        dev.update(busy_s=trace.busy_s, window_s=trace.wall_s)
        out["breakdown"] = trace.breakdown()
    out["checks"] = {k: {"value": numbers.get(k), "limit": lim} for k, lim in limits.items()}
    return out


def _free(device: torch.device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


def judge(root: pathlib.Path, config: dict, material: dict, layout, answers: list, split,
          log) -> dict:
    """The worst of each number over the sampled answers and, where the
    entry split a request, the state a trip short of its end
    (reference/compare; module doc)."""
    ref = importlib.import_module(f"{PKG}.reference.{config['reference']}")
    problem = ref.Problem(config, material, root)
    try:
        mapped = compare.Mapped(problem, *layout)
    except compare.LayoutError as exc:
        log(f"check: {exc}")
        return {}
    worst: dict = {}

    def keep(found: dict) -> None:
        for k, v in found.items():
            worst[k] = max(worst.get(k, v), v)

    start = problem.start()
    if split is not None:
        if not all(np.array_equal(a, b) for a, b in zip(split["layout"], layout)):
            log("check: the split run's mesh is not the timed run's")
            return {}
        start = split["before"]["ep"]
        keep(compare.numbers(problem, mapped, split["before"], final=False))
        keep({"resume_gap": max(compare.resume_gap(split["resumed"], a) for a in answers)})
    for a in answers:
        keep(compare.numbers(problem, mapped, a, start))
    return worst


def numbers_of(result: dict) -> list:
    """The compared numbers as short lines, for the end of standard error."""
    return [f"check {k} {v['value']!r} limit {v['limit']!r}" for k, v in result["checks"].items()]
