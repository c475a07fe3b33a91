"""The port's benchmark: one run of one cell.

    python3 -m port_bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout that holds `BENCHMARK.json`, this package
and the port (`fem_elastoplasticity_tpu_torch`).  It needs as many CUDA
cards as the cell asks for, and exits with a non-zero code and prints no
result without them, without the port, or where the process has loaded JAX
or the JAX package by the time the window has closed.  Earlier lines of
standard output give the card, its power limit and the peak memory; the
last lines of standard error the numbers compared with their limits; the
last line of standard output the result as one JSON object.  Builds of the
port's kernels go to `.torch_ext_build/` inside the checkout.  The process
keeps to one host core (the last it may use), and the port's host thread
pools get one thread (`OMP_NUM_THREADS` and the like, unless the
environment sets them).  A traced run whose spans or per-layer metrics
find nothing in the trace exits with code 5 and prints no result.
"""
from __future__ import annotations

import time

T_IMPORT = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
# one host thread for the port's CPU work: the run is paced by the one
# Python thread that launches the kernels, and idle pool threads spinning
# beside it on a shared host only add noise
THREAD_VARS = ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS")
FORBIDDEN = ("jax", "jaxlib", "flax", "fem_elastoplasticity_tpu")


def process_start() -> float:
    """Wall-clock time at which this process started: its age from
    /proc (10 ms ticks) taken from now; the module's import time where
    /proc cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - ticks / os.sysconf("SC_CLK_TCK")
        return time.time() - age if 0.0 <= age < 3600.0 else T_IMPORT
    except (OSError, ValueError, IndexError):
        return T_IMPORT


def loaded_forbidden() -> list:
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole (the port's name only begins with the JAX package's)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def pin_host() -> str:
    """Keep this process, and every thread it starts from here on, to one
    core: the last of those it may use.  Returns what was done."""
    try:
        core = max(os.sched_getaffinity(0))
        os.sched_setaffinity(0, {core})
    except (AttributeError, OSError) as exc:
        return f"not pinned ({exc})"
    return f"pinned to core {core}"


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown (nvidia-smi did not answer)"
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else "unknown"


def main(argv=None) -> int:
    t_process = process_start()
    pinned = pin_host()
    for var in THREAD_VARS:
        os.environ.setdefault(var, "1")
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    err = lambda line: print(line, file=sys.stderr, flush=True)  # noqa: E731
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = next((w for w in bench["workloads"] if w["name"] == args.workload), None)
    if cell is None:
        err(f"port_bench: no workload {args.workload!r} in BENCHMARK.json")
        return 2

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        err(f"port_bench: the cell needs {cell['chips']} CUDA card(s); "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible")
        return 3
    from port_bench import harness
    from port_bench.trace import TraceError

    device = torch.device("cuda:0")
    err(f"port_bench: host {pinned}")
    try:
        result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                                  bool(args.trace), device, t_process, err)
    except TraceError as exc:
        err(f"port_bench: trace: {exc}")
        return 5
    print(f"card: {card_line()}", flush=True)
    found = loaded_forbidden()
    if found:
        err(f"port_bench: the process has loaded {', '.join(found)}")
        return 4
    print(f"memory_peak_bytes (torch.cuda.max_memory_allocated): "
          f"{result['device']['memory_peak_bytes']}", flush=True)
    for line in harness.numbers_of(result):
        err(line)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
