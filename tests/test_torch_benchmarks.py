"""PyTorch port: the sweeps of `fem_elastoplasticity_tpu_torch/benchmarks/`
held against the JAX package's sweeps on the same inputs, on the CPU.

The JAX records come from `tests/fixtures/torch_port/benchmark_sweeps.json`
(`tools/make_port_fixtures.py sweeps`: the JAX sweep functions themselves
at these sizes, their deterministic fields; no time).  Tolerances:

* assembly sweep, levels 0-1: elements x4 a level, DOFs equal, walls > 0;
* solve sweep, level 0, "mg" and "jacobi": 952 DOFs, CG iterations within
  one of JAX's;
* spmv_bench, level 0: nnz equal, K6's plain product within 2e-6 (of the
  largest entry) of the matrix-free product;
* dp_scale, level 1 cut at zeta 3/17: steps, Newton iterations and plastic
  points equal, CG within one iteration (the port's f32 sums round in
  another order; 9 against 8), u40 within 1e-12 relative;
* elastic_df32 and elastic_ell ("slot", "ell"), level 1: CG iterations a
  refinement pass within one of JAX's, u_max within 1e-11 (relative) of an
  f64 block-Jacobi CG solve and of JAX's record;
* ensemble, the 2 x 2 grid: min/max steps equal (f32 and df32);
* footing, level 1 cut at zeta 0.02: steps and plastic points equal,
  Newton iterations by load trip (`footing.newton_trip_gaps` against the
  same configuration's trip record, `footing_df32_cg_z002.npz`), CG within
  5%, limit pressure within 1e-9 (relative);
* p4_tsx_bench, cut at zeta 1/17 through a stand-in config: steps, Newton,
  CG and plastic counts those of the fixture of the route the default
  `gs_tangent` resolves to, u40 within 1e-9 of its monitor.

Every sweep given no device needs a card and raises without one; the
package and its nine modules import no JAX.
"""
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu_torch.benchmarks import (
    assembly_sweep,
    dp_scale_bench,
    elastic_df32_sweep,
    elastic_ell_sweep,
    ensemble_bench,
    footing_scale_bench,
    p4_tsx_bench,
    solve_sweep,
    spmv_bench,
)
from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes, lame_moduli
from fem_elastoplasticity_tpu_torch.models.tsx_tunnel import initial_state, tsx_mesh
from fem_elastoplasticity_tpu_torch.ops import assembly as asm
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element
from fem_elastoplasticity_tpu_torch.solve.cg import solve_cg, stiffness_block_jacobi

# small solves: threads only contend (and the batched f32 solves of the
# df32 ensemble stall in MKL with more than one)
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
JAX = json.loads((FIXTURES / "benchmark_sweeps.json").read_text())
MODULES = ("assembly_sweep", "solve_sweep", "spmv_bench", "dp_scale_bench",
           "elastic_df32_sweep", "elastic_ell_sweep", "ensemble_bench",
           "footing_scale_bench", "p4_tsx_bench")


@pytest.fixture(scope="module")
def u_max_f64():
    """max |u| of the f64 elastic solve K u = -F0 at level 1: matrix-free
    block-Jacobi CG at 1e-14 (the JAX package's own gate,
    tests/test_benchmarks.py)."""
    cfg = TsxTunnelConfig()
    mesh = tsx_mesh(ElementType.P1, refine_levels=1)
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    s0, _ = initial_state(cfg)
    geom = asm.compute_geometry(torch.as_tensor(mesh.coords), mesh.elems,
                                volume_element(ElementType.P1))
    f0 = asm.internal_force(geom, torch.as_tensor(s0[:3])[:, None].expand(3, geom.n_int))
    D = elastic_tangent_lanes(shear, bulk, geom.n_int)
    free = torch.as_tensor(mesh.free)
    res = solve_cg(lambda v: asm.tangent_matvec(geom, D, v), -f0, free,
                   precond=stiffness_block_jacobi(geom, D, free), tol=1e-14, maxiter=4000)
    return float(res.x.abs().max())


def test_assembly_sweep():
    recs = assembly_sweep.run_assembly_sweep(levels=1, reps=1, verbose=False, device="cpu")
    assert [(r["level"], r["n_elems"], r["n_dofs"]) for r in recs] == [
        (j["level"], j["n_elems"], j["n_dofs"]) for j in JAX["assembly"]]
    assert recs[1]["n_elems"] == 4 * recs[0]["n_elems"]
    assert all(r["assemble_apply_s"] > 0 and r["assemble_apply_eager_s"] > 0
               and r["gdof_per_s"] > 0 for r in recs)


@pytest.mark.parametrize("preconditioner", ["mg", "jacobi"])
def test_solve_sweep(preconditioner):
    rec, = solve_sweep.run_solve_sweep(levels=(0,), reps=1, verbose=False, time_newton=True,
                                       preconditioner=preconditioner, device="cpu")
    want = JAX[f"solve_{preconditioner}"]
    assert rec["n_dofs"] == want["n_dofs"] == 952
    assert rec["n_elems"] == want["n_elems"]
    assert abs(rec["cg_iters"] - want["cg_iters"]) <= 1, (rec["cg_iters"], want["cg_iters"])
    assert rec["elastic_cg_s"] > 0 and rec["newton_iter_s"] > 0


def test_spmv_bench(capsys):
    rec = spmv_bench.main(0, reps=1, device="cpu")
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == rec
    assert (rec["n_dofs"], rec["nnz"]) == (JAX["spmv"]["n_dofs"], JAX["spmv"]["nnz"])
    assert rec["max_rel_diff"] <= 2e-6
    assert rec["value"] > 0 and rec["matrix_free_ms"] > 0


def test_dp_scale_bench():
    rec, = dp_scale_bench.run_dp_scale(levels=(1,), reps=0, verbose=False, device="cpu",
                                       zeta_max=3 / 17)
    want = JAX["dp_scale"]
    keys = ("n_elems", "n_dofs", "n_steps", "n_newton_total", "n_plastic")
    assert {k: rec[k] for k in keys} == {k: want[k] for k in keys}
    assert abs(rec["n_cg_total"] - want["n_cg_total"]) <= 1, (rec["n_cg_total"],
                                                              want["n_cg_total"])
    assert abs(rec["u40"] - want["u40"]) <= 1e-12 * abs(want["u40"])


def check_refined(rec, want, u64):
    assert (rec["n_elems"], rec["n_dofs"]) == (want["n_elems"], want["n_dofs"])
    got, ref = rec["cg_iters_per_ir_pass"], want["cg_iters_per_ir_pass"]
    assert len(got) == len(ref) == 3 and all(abs(a - b) <= 1 for a, b in zip(got, ref)), (got, ref)
    assert abs(rec["u_max"] - u64) <= 1e-11 * u64
    assert abs(rec["u_max"] - want["u_max"]) <= 1e-11 * want["u_max"]


def test_elastic_df32_sweep(u_max_f64):
    rec, = elastic_df32_sweep.run_elastic_df32_sweep(levels=(1,), reps=0, verbose=False,
                                                     device="cpu")
    check_refined(rec, JAX["elastic_df32"], u_max_f64)


@pytest.mark.parametrize("fmt", ["slot", "ell"])
def test_elastic_ell_sweep(fmt, u_max_f64):
    rec, = elastic_ell_sweep.run_elastic_ell_sweep(levels=(1,), reps=0, verbose=False, fmt=fmt,
                                                   device="cpu")
    check_refined(rec, JAX[f"elastic_ell_{fmt}"], u_max_f64)
    assert rec["op_layout"]["format"] == fmt


def test_ensemble_bench():
    extras = {}
    rec = ensemble_bench.run_ensemble_bench(2, 2, verbose=False, device="cpu", extras=extras)
    keys = ("ensemble_size", "min_steps", "max_steps", "df32_min_steps", "df32_max_steps")
    assert {k: rec[k] for k in keys} == {k: JAX["ensemble"][k] for k in keys}
    assert extras["f32"].n_steps.shape == extras["df32"].n_steps.shape == (4,)


def test_footing_scale_bench():
    cut = JAX["config"]["footing"]
    extras = {}
    rec, = footing_scale_bench.run_footing_scale(levels=(cut["level"],), reps=0, verbose=False,
                                                 device="cpu", extras=extras,
                                                 zeta_max=cut["zeta_max"])
    want = JAX["footing"]
    keys = ("n_elems", "n_dofs", "n_steps", "n_plastic")
    assert {k: rec[k] for k in keys} == {k: want[k] for k in keys}
    # the trip record of the same trajectory: FootingConfig.fast(solver="cg",
    # zeta_max=0.02), whose CG never reaches the sweep's cg_maxiter=4000
    trips = np.load(FIXTURES / "footing_df32_cg_z002.npz")
    assert (int(trips["n_steps"]), int(trips["n_newton_total"]), int(trips["n_cg_total"])) == (
        want["n_steps"], want["n_newton_total"], want["n_cg_total"])
    r, cfg = extras["results"][0], extras["configs"][0]
    assert footing.newton_trip_gaps(r, trips["newton_trips"], cfg) == []
    assert cfg == FootingConfig.fast(level=1, solver="cg", cg_maxiter=4000, zeta_max=0.02)
    assert abs(rec["n_cg_total"] - want["n_cg_total"]) <= 0.05 * want["n_cg_total"]
    assert abs(rec["limit_pressure"] - want["limit_pressure"]) <= 1e-9 * want["limit_pressure"]
    assert abs(rec["zeta_end"] - want["zeta_end"]) <= 1e-7 * want["zeta_end"]


def test_p4_tsx_bench(monkeypatch):
    class StandIn:
        """TsxTunnelConfig whose fast preset stops after the first load step."""

        @staticmethod
        def fast(**kw):
            return TsxTunnelConfig.fast(zeta_max=1 / 17, **kw)

    monkeypatch.setattr(p4_tsx_bench, "TsxTunnelConfig", StandIn)
    rec = p4_tsx_bench.main(device="cpu")
    route = "gs" if StandIn.fast(etype=ElementType.P4, solver="ell").gs_tangent_on else "mf"
    want = np.load(FIXTURES / f"tsx_p4_pmg_{route}_z1.npz")
    for k in ("n_steps", "n_newton_total", "n_plastic", "n_cg_total"):
        assert rec[k] == int(want[k]), (k, rec[k], int(want[k]))
    u40 = float(want["displ_hist"][int(want["n_steps"]) - 1])
    assert abs(rec["u40"] - u40) <= 1e-9 * abs(u40)
    assert rec["path"] == "df32_ell" and rec["value"] > 0


SWEEP_CALLS = {
    "assembly_sweep": lambda: assembly_sweep.run_assembly_sweep(levels=0),
    "solve_sweep": lambda: solve_sweep.run_solve_sweep(levels=(0,)),
    "spmv_bench": lambda: spmv_bench.main(0),
    "dp_scale_bench": lambda: dp_scale_bench.run_dp_scale(levels=(1,)),
    "elastic_df32_sweep": lambda: elastic_df32_sweep.run_elastic_df32_sweep(levels=(0,)),
    "elastic_ell_sweep": lambda: elastic_ell_sweep.run_elastic_ell_sweep(levels=(0,)),
    "ensemble_bench": lambda: ensemble_bench.run_ensemble_bench(2, 2),
    "ensemble_scale_bench": lambda: ensemble_bench.run_ensemble_scale_bench(4),
    "footing_scale_bench": lambda: footing_scale_bench.run_footing_scale(levels=(1,)),
    "p4_tsx_bench": lambda: p4_tsx_bench.main(),
}


@pytest.mark.parametrize("name", sorted(SWEEP_CALLS))
def test_sweep_without_device_needs_a_card(name, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        SWEEP_CALLS[name]()


def test_benchmarks_import_without_jax():
    code = (
        "import sys, fem_elastoplasticity_tpu_torch.benchmarks\n"
        + "".join(f"import fem_elastoplasticity_tpu_torch.benchmarks.{m}\n" for m in MODULES)
        + "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('fem_elastoplasticity_tpu.') or m == 'fem_elastoplasticity_tpu']\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_spmv_bench_command_line():
    proc = subprocess.run(
        [sys.executable, "-m", "fem_elastoplasticity_tpu_torch.benchmarks.spmv_bench", "0",
         "--cpu"], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    assert (rec["metric"], rec["level"], rec["nnz"]) == ("ell_matvec_ms", 0, JAX["spmv"]["nnz"])


def test_package_exports():
    import fem_elastoplasticity_tpu_torch.benchmarks as b

    assert (b.run_assembly_sweep, b.run_solve_sweep, b.run_ensemble_bench) == (
        assembly_sweep.run_assembly_sweep, solve_sweep.run_solve_sweep,
        ensemble_bench.run_ensemble_bench)
