"""Benchmark sweeps of the port.

Port of `fem_elastoplasticity_tpu/benchmarks/`, the nine harnesses with
their module names, functions, parameters, defaults, command lines and
printed JSON keys: refinement-level assembly and solve sweeps, the sparse
product against the matrix-free one, the full adaptive solves at scale
(tsx, footing, P4), the elastic df32 solves on the matrix-free and the
assembled hierarchy, and material ensembles.  Each `run_*` / `main` takes
`device`: None runs on the card and raises without one, "cpu" runs on the
host with the plain versions of the kernels; each command line takes
`--cpu` for that.  Walls come from `utils/timing.py`.

    python -m fem_elastoplasticity_tpu_torch.benchmarks.<name> [args] [--cpu]
"""
from .assembly_sweep import run_assembly_sweep
from .solve_sweep import run_solve_sweep
from .ensemble_bench import run_ensemble_bench
