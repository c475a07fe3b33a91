"""PyTorch port: the strip footing's double-float and CG paths on the CPU.

`FootingConfig.fast()` (df32, dense), `FootingConfig(solver="cg")` (native
f64, block-Jacobi PCG on the matrix-free tangent), `FootingConfig.fast(
solver="cg")` (df32 PCG) and `FootingConfig.fast(solver="cg",
assembled_cg=True)` (df32 PCG on the assembled operator refreshed from
every integration point, through K3's plain version) are held to the JAX
package's runs of the same configurations, read from the committed
fixtures of `tools/make_port_fixtures.py` (no test re-runs a JAX solve).
The CG runs are truncated in ζ, as their fixtures are.  With -s the tests
print the port's counts beside the JAX package's.

The port carries the df32 state as f64 (`utils/precision.py`).  Its Newton
criterion therefore has a lower floor than the JAX package's two-float
arithmetic, whose criterion does not settle below a few 1e-12 (the last
trip of `fast()` runs all 25 iterations at 5.7e-12 against newton_tol
5e-12).  The df32 runs are held to the JAX run trip by trip (the fixtures'
`newton_trips`, `footing.newton_trip_gaps`): every load trip takes the JAX
run's Newton count, except that a trip may take fewer where the JAX run
ends at its floor (all newton_maxit iterations) or where the port's last
criterion lies within a decade below newton_tol (FLOOR_BAND), a value the
two-float criterion cannot tell from newton_tol: there the JAX run takes
one more iteration.
On the CPU that excuses trips 12, 14, 15 and 16 of `fast()` (one
iteration each, the port's last criteria 8.5e-13 to 2.3e-12, and the
floor trip) and trip 5 of `fast(solver="cg", zeta_max=0.02)` (4.7e-12).
The native f64 CG run is held to the JAX run's Newton total, and every CG
run to 5% of its CG iterations.

The full df32 CG schedules part from the JAX runs at load trip 18
(`tools/port_footing_trips.py`): there a CG solve hits cg_maxiter in the
JAX run at a Newton iteration where the port's converged (class (b) of
that tool; in the matrix-free run it is the iteration the two-float floor
adds).  The trips before it are held to the JAX runs' per-trip records,
as far as about 20 s of a run on one CPU thread reaches (trip 16 and 13).
"""
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu.ops import assembly as jasm
from fem_elastoplasticity_tpu.ops.elements import ElementType as JaxElementType
from fem_elastoplasticity_tpu.ops.elements import volume_element as jvolume_element
from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes, lame_moduli
from fem_elastoplasticity_tpu_torch.ops import assembly as pasm
from fem_elastoplasticity_tpu_torch.ops import spmv
from fem_elastoplasticity_tpu_torch.ops.elements import volume_element
from fem_elastoplasticity_tpu_torch.solve.newton import NewtonSettings, build_load_stepper

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
COUNTS = ("n_steps", "n_newton_total", "n_cg_total", "n_plastic")
CG_RUNS = {
    "footing_cg_f64_z0008": lambda: FootingConfig(solver="cg", zeta_max=0.008),
    "footing_df32_cg_z002": lambda: FootingConfig.fast(solver="cg", zeta_max=0.02),
    "footing_df32_acg_z002": lambda: FootingConfig.fast(
        solver="cg", assembled_cg=True, cg_maxiter=4000, zeta_max=0.02),
}
_RUNS: dict = {}


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def run(name: str):
    """(result, kernel-route counts) of a CG configuration, solved once a
    module."""
    if name not in _RUNS:
        spmv.LAUNCHES.clear()
        _RUNS[name] = footing.solve(CG_RUNS[name](), device="cpu"), dict(spmv.LAUNCHES)
    return _RUNS[name]


def counts(r) -> tuple:
    return tuple(int(getattr(r, k)) for k in COUNTS)


@pytest.fixture(scope="module")
def f64_result():
    return footing.solve(FootingConfig(), device="cpu")


def test_fast_dense_follows_the_f64_run_and_jax(f64_result):
    """The dense df32 preset: the f64 run's 16 steps, its ζ history within
    1e-6, u within 1e-9 and pressures within 1e-5 (JAX
    `tests/test_footing.py:188-204`), and the JAX df32 fixture's 16 steps
    and u within 1e-9; the JAX run's Newton count on every load trip but
    those that end in the two-float floor band (module doc)."""
    spmv.LAUNCHES.clear()
    r = footing.solve(FootingConfig.fast(), device="cpu")
    assert not spmv.LAUNCHES  # no operator product on the dense path
    exp = np.load(FIXTURES / "footing_df32.npz")
    f64 = np.load(FIXTURES / "footing_f64.npz")
    print(f"footing df32 dense: port {counts(r)}, JAX {tuple(int(exp[k]) for k in COUNTS)}, "
          f"port f64 {f64_result.n_steps} / {f64_result.n_newton_total}; Newton by trip: port "
          f"{r.newton_trips}, JAX {tuple(int(k) for k in exp['newton_trips'])}")
    r64 = f64_result
    assert r.n_steps == r64.n_steps == int(exp["n_steps"]) == 16
    np.testing.assert_allclose(r.zeta_hist[1:17], r64.zeta_hist[1:17], rtol=1e-6)
    assert rel(r.u, r64.u) < 1e-9
    assert rel(r.pressure_hist[1:17], r64.pressure_hist[1:17]) < 1e-5
    assert rel(r.u, exp["u"]) < 1e-9
    assert rel(r.pressure_hist[1:17], exp["pressure_hist"][1:17]) < 1e-5
    assert r.n_plastic == int(exp["n_plastic"])
    assert footing.newton_trip_gaps(r, exp["newton_trips"], FootingConfig.fast()) == []
    assert int(f64["n_newton_total"]) <= r.n_newton_total <= int(exp["n_newton_total"])
    assert r.n_cg_total == 0


@pytest.mark.parametrize("name", list(CG_RUNS))
def test_cg_paths_against_jax_fixtures(name):
    """Steps and plastic points as the JAX run has them, Newton iterations
    by trip (df32, module doc) or in total (f64) as the JAX run has them,
    CG iterations within 5%, u and the pressure history within
    1e-9 (1e-6 for the f32 pressure heads of df32); the assembled path's
    products went through K3's and K1's plain versions (on the card: the
    kernels)."""
    r, launches = run(name)
    exp = np.load(FIXTURES / f"{name}.npz")
    want = tuple(int(exp[k]) for k in COUNTS)
    print(f"{name}: port {counts(r)}, JAX {want} (steps / Newton / CG / plastic); Newton by "
          f"trip {r.newton_trips}")
    s = r.n_steps
    assert (s, r.n_plastic) == (want[0], want[3])
    if "newton_trips" in exp:
        assert footing.newton_trip_gaps(r, exp["newton_trips"], CG_RUNS[name]()) == []
    else:
        assert r.n_newton_total == want[1]
    assert abs(r.n_cg_total - want[2]) <= 0.05 * want[2]
    assert r.u.shape == (441, 2) and r.ep.shape == (4, 896)
    assert rel(r.u, exp["u"]) < 1e-9
    assert rel(r.ep, exp["ep"]) < 1e-8
    np.testing.assert_allclose(r.zeta_hist[1:s + 1], exp["zeta_hist"][1:s + 1], rtol=1e-6)
    assert rel(r.pressure_hist[1:s + 1], exp["pressure_hist"][1:s + 1]) < (
        1e-9 if name.startswith("footing_cg_f64") else 1e-6)
    if "acg" in name:
        assert launches["node_block_spmv_plain"] >= r.n_cg_total  # every CG product
        assert launches["csr_spmv_f64_plain"] > 0  # the residual's G and S
        assert not {k: v for k, v in launches.items() if not k.endswith("_plain")}
    else:
        assert not launches


# the full schedules (no zeta cut); both part from the JAX runs at load
# trip 18 (tools/port_footing_trips.py prints them whole), and each test
# run stops at the last trip before it that about 20 s on one CPU thread
# reaches
FULL_RUNS = {
    "footing_df32_cg_full": (dict(solver="cg"), 16),
    "footing_df32_acg_full": (dict(solver="cg", assembled_cg=True, cg_maxiter=4000), 13),
}


@pytest.mark.parametrize("name", list(FULL_RUNS))
def test_full_cg_schedule_follows_jax_up_to_its_parting_trip(name):
    """Every load trip before the parting trip against the JAX run's record
    (`footing_df32_cg_full.npz`, `footing_df32_acg_full.npz`): Newton
    iterations by `newton_trip_gaps`, zeta after the trip within 1e-12, the
    same steps accepted and rejected (the rejected trips are those whose
    CG solve hit cg_maxiter), CG iterations within 5% of the JAX run's over
    those trips."""
    kw, n_trips = FULL_RUNS[name]
    cfg = FootingConfig.fast(**kw, max_trips=n_trips)
    r = footing.solve(cfg, device="cpu")
    exp = np.load(FIXTURES / f"{name}.npz")
    n = n_trips
    print(f"{name} through trip {n}: Newton by trip {r.newton_trips}, JAX "
          f"{tuple(int(k) for k in exp['newton_trips'][:n])}; CG by trip "
          f"{tuple(sum(k for k, _ in t) for t in r.cg_trips)}, JAX "
          f"{tuple(int(k) for k in exp['cg_trips'][:n])}")
    assert len(r.newton_trips) == n
    assert footing.newton_trip_gaps(r, exp["newton_trips"][:n], cfg) == []
    np.testing.assert_allclose(r.zeta_trips, exp["zeta_trips"][:n], rtol=0, atol=1e-12)
    accepted = [c == c and c < cfg.accept_tol for c in r.crit_trips]
    assert accepted == exp["accepted_trips"][:n].astype(bool).tolist()
    capped = [k for k, t in enumerate(r.cg_trips) if not all(ok for _, ok in t)]
    assert capped == [k for k in range(n) if not accepted[k]]
    cg, cg_jax = sum(k for t in r.cg_trips for k, _ in t), int(exp["cg_trips"][:n].sum())
    assert abs(cg - cg_jax) <= 0.05 * cg_jax


def test_assembled_matches_matrix_free_cg():
    """The JAX package's pairing (`tests/test_footing.py:219-241`): the
    assembled operator takes the matrix-free path's schedule, ζ within
    rtol 1e-9, pressures within 1e-6."""
    ra, _ = run("footing_df32_acg_z002")
    rf, _ = run("footing_df32_cg_z002")
    assert ra.n_steps == rf.n_steps
    s = ra.n_steps
    np.testing.assert_allclose(ra.zeta_hist[1:s + 1], rf.zeta_hist[1:s + 1], rtol=1e-9)
    assert rel(ra.pressure_hist[1:s + 1], rf.pressure_hist[1:s + 1]) < 1e-6
    assert rel(ra.u, rf.u) < 1e-9
    # the assembled result is handed back on the reference mesh
    np.testing.assert_array_equal(ra.mesh.coords, rf.mesh.coords)


def test_newton_trip_gaps_rule():
    """The per-trip rule of the module doc on a made-up three-trip history:
    fewer iterations pass only at the reference's maxit or with a last
    criterion in the floor band; more never pass; another length is a gap."""
    cfg = FootingConfig.fast()  # newton_tol 5e-12, newton_maxit 25
    r = footing.FootingResult(None, None, None, None, 3, 0, 0, None,
                              newton_trips=(7, 6, 8), crit_trips=(1e-14, 2e-12, 1e-13))
    gaps = lambda ref: [g[0] for g in footing.newton_trip_gaps(r, ref, cfg)]  # noqa: E731
    assert gaps((7, 6, 8)) == []
    assert gaps((7, 7, 25)) == []  # trip 2 in the band, trip 3 at maxit
    assert gaps((8, 7, 9)) == [1, 3]  # below the band, short of maxit
    assert gaps((6, 6, 8)) == [1]  # more than the reference
    assert gaps((7, 6)) == [2]


def test_node_block_diagonal_equals_jax():
    mesh = footing.build_mesh(FootingConfig())
    jg = jasm.compute_geometry(
        jnp.asarray(mesh.coords), jnp.asarray(mesh.elems), jvolume_element(JaxElementType.P1))
    pg = pasm.compute_geometry(torch.as_tensor(mesh.coords), mesh.elems,
                               volume_element(mesh.etype))
    rng = np.random.default_rng(11)
    a = rng.normal(size=(3, 3, pg.n_int))
    d = a + a.transpose(1, 0, 2)
    got = pasm.node_block_diagonal(pg, torch.as_tensor(d)).numpy()
    exp = np.asarray(jasm.node_block_diagonal(jg, jnp.asarray(d)))
    assert got.shape == (mesh.n_nodes, 2, 2)
    assert rel(got, exp) < 1e-13
    smap = pasm.node_slot_map(pg)
    np.testing.assert_array_equal(pasm.node_block_diagonal(pg, torch.as_tensor(d), smap), got)


@pytest.mark.parametrize("kw", [
    dict(solver="cg", cg_deflate=4),
    dict(solver="cg", newton_damping=1),
    dict(solver="cg", tangent_mg=True),
    dict(cg_structure="scan"),  # dense solver: no CG loop
    dict(solver="cg", residual_fmt="ell"),
    dict(solver="cg", assembled_cg=True),  # native precision
    dict(assembled_cg=True, precision="df32", dtype="float32"),  # dense solver
    dict(solver="cg", cg_eta0=1e-2),  # native precision
    dict(cg_maxiter=4000),  # dense solver
    dict(solver="cg", dense_mode="mixed"),
    dict(solver="ell"),
], ids=lambda kw: ",".join(f"{k}={v}" for k, v in kw.items()))
def test_unported_combinations_are_refused(kw):
    with pytest.raises(NotImplementedError):
        FootingConfig(**kw)


def test_refusals_outside_the_config():
    with pytest.raises(NotImplementedError):
        FootingConfig.fast_scale(4, residual_fmt="ell")
    with pytest.raises(ValueError):
        footing.build_df32(FootingConfig(), device="cpu")
    # the stepper's CG on an assembled operator needs the full refresh
    mesh = footing.build_mesh(FootingConfig())
    geom = pasm.compute_geometry(torch.as_tensor(mesh.coords), mesh.elems,
                                 volume_element(mesh.etype))
    shear, bulk = lame_moduli(1e7, 0.48)
    settings = NewtonSettings(25, 1e-12, 1e-10, 1e-6, 1.0, 10, 1)
    with pytest.raises(NotImplementedError):
        build_load_stepper(geom, torch.arange(4), None, shear, bulk, 0.5, 1.0, settings,
                           monitor=lambda u, s: u[0], solver="cg", elastic_op=object())
    D = elastic_tangent_lanes(shear, bulk, geom.n_int, torch.float64, torch.device("cpu"))
    assert pasm.node_block_diagonal(geom, D).shape == (mesh.n_nodes, 2, 2)
