"""PyTorch port: the tsx's last single-device options.

The matrix-free multigrid (`solver="mg"`, native and df32), the W-cycle,
the support pressure, the deflated CG, the fixed-trip CG loop
(`cg_structure="scan"`), P2 p-multigrid on ELL residual operators and the
chunked, checkpointed run.  The pieces are held to the JAX package on
identical inputs (the wall edges, the pressure traction, one V-cycle of
the matrix-free hierarchy, one W-cycle on the assembled one); the runs to
the JAX package's runs that `tools/make_port_fixtures.py` writes
(`TSX_OPTIONS`, each storing its configuration): steps and plastic points
equal, Newton iterations by trip for df32 (in total for native f64), CG
within 5%, u within 1e-9 relative.  The JAX package cannot run P2 on ELL
residual operators (`tools/make_port_fixtures.py` says why), so that run
is held to the JAX fixtures of the same routes on CSR operators.  The full
schedules beyond the level-1 W-cycle and the support pressure run on the
card (`chip_smoke.py` phase 35).
"""
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu.models import tsx_tunnel as jtsx
from fem_elastoplasticity_tpu.models.materials import elastic_tangent_lanes as jtangent
from fem_elastoplasticity_tpu.models.materials import lame_moduli
from fem_elastoplasticity_tpu.ops import assembly as jasm
from fem_elastoplasticity_tpu.ops import elements as jel
from fem_elastoplasticity_tpu.solve import multigrid as jmg
from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.ops import assembly as pasm
from fem_elastoplasticity_tpu_torch.ops import elements as pel
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.solve import cg as pcg
from fem_elastoplasticity_tpu_torch.solve import multigrid as pmg
from fem_elastoplasticity_tpu_torch.utils.convert import load_checkpoint

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "tools"))
from make_port_fixtures import TSX_OPTIONS, tsx_option_config  # noqa: E402

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
SHEAR, BULK = lame_moduli(60000.0, 0.2)


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def fixture(name: str) -> dict:
    return dict(np.load(FIXTURES / f"{name}.npz"))


def config_of(want: dict, **kw) -> TsxTunnelConfig:
    c = json.loads(want["config"].item())
    preset = c.pop("preset")
    return tsx_option_config(TsxTunnelConfig, pel.ElementType, preset, {**c, **kw})


# cuts whose every load step is elastic: the warm start of a step is its
# solution up to rounding, so each Newton solve runs on a rounding residual
# whose CG count moves with the last bits of the f64 state (the JAX
# package's state is two-float): on the port's own right-hand side the two
# packages' CG agree (1 / 2 / 3 iterations to 1e-6 of the residual ratio),
# but `fast_scale(1, cg_deflate=4, zeta_max=3/17)` takes 3 / 3 / 2 here
# against the JAX run's 3 / 2 / 2, and undeflated 3 / 3 / 3 against
# 3 / 3 / 2.  Their CG is printed, not held; the full schedules hold it.
ELASTIC_CUTS = ("tsx_mg_native_z2", "tsx_mg_df32_z2", "tsx_scale_l1_defl4_z3")


def check_run(want: dict, res, r, cfg, hold_cg: bool = True) -> None:
    """A port run (its LoadSteppingResult `res`, None for native f64, and
    its TsxResult `r`) against the JAX run `want` of the same route."""
    assert r.n_steps == int(want["n_steps"])
    assert r.n_plastic == int(want["n_plastic"])
    if res is None:  # native: the JAX native run records no trips
        assert r.n_newton_total == int(want["n_newton_total"])
    else:
        assert footing.newton_trip_gaps(res, want["newton_trips"], cfg) == []
    n_cg = int(want["n_cg_total"])
    print(f"CG {r.n_cg_total} (JAX {n_cg})")
    if hold_cg:
        assert abs(r.n_cg_total - n_cg) <= 0.05 * n_cg, (r.n_cg_total, n_cg)
    assert rel(r.u, want["u"]) < 1e-9
    assert rel(r.displ_hist[: r.n_steps], want["displ_hist"][: r.n_steps]) < 1e-9


def run_port(cfg):
    """(LoadSteppingResult or None, TsxResult) of a port run on the CPU."""
    if cfg.precision != "df32":
        return None, tsx.solve(cfg, device="cpu")
    extras = {}
    run, mesh = tsx.build_df32(cfg, device="cpu", extras=extras)
    res = run()
    return res, tsx._df32_result(res, mesh, extras)


# ---------------------------------------------------------------------------
# cg_structure="scan": the seeded systems of tests/test_cg.py:50-83
# ---------------------------------------------------------------------------
def _spd(n, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.normal(size=(n, n))
    return A @ A.T + n * np.eye(n)


@pytest.mark.parametrize("deflate", [False, True], ids=["plain", "deflated"])
def test_scan_structure_matches_while(deflate):
    n = 48
    K = torch.as_tensor(np.kron(_spd(n, 7), np.eye(2)))
    free = np.ones((n, 2), bool)
    free[:3] = False
    free = torch.as_tensor(free)
    b = torch.as_tensor(np.random.default_rng(8).normal(size=2 * n))
    kw = dict(tol=1e-13, maxiter=300)
    if deflate:
        W = torch.as_tensor(np.linalg.qr(np.random.default_rng(9).normal(size=(2 * n, 3)))[0])
        kw["deflate"] = W * free.reshape(-1, 1)
    r_w = pcg.solve_cg(lambda v: K @ v, b, free, structure="while", **kw)
    r_s = pcg.solve_cg(lambda v: K @ v, b, free, structure="scan", **kw)
    assert r_s.iters == r_w.iters > 0
    assert r_s.converged == r_w.converged == (not deflate)  # the deflated one meets the floor
    assert torch.equal(r_s.x, r_w.x) and torch.equal(r_s.z, r_w.z)


def test_scan_structure_cap_hit_flags_nonconverged():
    n = 64
    K = torch.as_tensor(np.kron(_spd(n, 9), np.eye(2)))
    b = torch.as_tensor(np.random.default_rng(10).normal(size=2 * n))
    free = torch.ones((n, 2), dtype=torch.bool)
    res = pcg.solve_cg(lambda v: K @ v, b, free, tol=1e-14, maxiter=3, structure="scan")
    ref = pcg.solve_cg(lambda v: K @ v, b, free, tol=1e-14, maxiter=3)
    assert not res.converged and res.iters == 3
    assert torch.isfinite(res.x).all() and torch.equal(res.x, ref.x)


# ---------------------------------------------------------------------------
# support pressure: the wall edges and the traction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("et", ["P1", "P2", "P4"])
def test_wall_edges_and_pressure_traction_match_jax(et):
    jm = jtsx.tsx_mesh(jel.ElementType[et])
    pm = tsx.tsx_mesh(pel.ElementType[et])
    je, pe = jtsx.tunnel_wall_edges(jm), tsx.tunnel_wall_edges(pm)
    np.testing.assert_array_equal(pe, je)
    assert pe.shape[0] > 0 and pe.shape[1] == {"P1": 2, "P2": 3, "P4": 5}[et]
    with jax.default_device(jax.devices("cpu")[0]):
        want = np.asarray(jasm.pressure_traction_vector(
            jnp.asarray(jm.coords, jnp.float64), jnp.asarray(je),
            jel.surface_element(jel.ElementType[et]), jnp.asarray(3.0, jnp.float64),
            jm.n_nodes))
    got = pasm.pressure_traction_vector(torch.as_tensor(pm.coords), pe,
                                        pel.surface_element(pel.ElementType[et]), 3.0,
                                        pm.n_nodes).numpy()
    assert np.abs(got - want).max() <= 1e-14 * np.abs(want).max()
    # a pressure pushes the wall outward: the total force is no longer zero
    # only through the ellipse's asymmetry, and it acts on wall nodes alone
    wall = np.unique(pe)
    off = np.setdiff1d(np.arange(pm.n_nodes), wall)
    assert (got.reshape(-1, 2)[off] == 0).all()


# ---------------------------------------------------------------------------
# the matrix-free V-cycle and the W-cycle
# ---------------------------------------------------------------------------
def _jax_mf_vcycle(refine):
    """The JAX package's matrix-free V-cycle of the tsx hierarchy, f64,
    built as its df32 path hoists it (`mg_level_arrays` under jit) and
    applied under jit."""
    with np.load(jtsx._DATA) as raw:
        c, e = raw["coords"].astype(np.float64), raw["elems"]
    hier = jmg.build_hierarchy(c, e, refine, tsx._free_of)
    d_fn = lambda g: jtangent(SHEAR, BULK, g.n_int, jnp.float64)  # noqa: E731
    arrays = jax.jit(lambda h, t: jmg.mg_level_arrays(jmg.build_mg_levels(h, t, d_fn))[0])(
        hier, jel.tables(jel.volume_element(jel.ElementType.P1)))
    levels = jmg.mg_levels_from_arrays(
        arrays, [(int(h.coords.shape[0]), 1, int(h.elems.shape[0])) for h in hier])
    lev0 = levels[0]
    fmap0, n_free0 = jasm.free_dof_map(np.asarray(hier[0].free))
    idx0 = jnp.asarray(np.nonzero(np.asarray(hier[0].free).reshape(-1))[0])
    K0 = jasm.assemble_dense_free(jasm.element_stiffness(lev0.geom, lev0.d), lev0.geom,
                                  jnp.asarray(fmap0), n_free0)
    cho = jax.scipy.linalg.cho_factor(K0)

    def coarse(r):
        return jnp.zeros_like(r).at[idx0].set(jax.scipy.linalg.cho_solve(cho, r[idx0]))

    return jax.jit(jmg.make_vcycle(levels, coarse, nu=2)), levels[-1].free_flat


def test_matrix_free_hierarchy_and_vcycle_match_jax():
    with np.load(jtsx._DATA) as raw:
        c, e = raw["coords"].astype(np.float64), raw["elems"]
    jh = jmg.build_hierarchy(c, e, 1, tsx._free_of)
    ph = pmg.build_hierarchy(c, e, 1, tsx._free_of)
    for j, p in zip(jh, ph):
        np.testing.assert_array_equal(p.coords, np.asarray(j.coords))
        np.testing.assert_array_equal(p.elems, np.asarray(j.elems))
        np.testing.assert_array_equal(p.free, np.asarray(j.free))
        np.testing.assert_array_equal(p.parents, np.asarray(j.parents))
    # the fine level is the refined tsx mesh, node for node
    np.testing.assert_array_equal(ph[-1].coords, tsx.tsx_mesh(refine_levels=1).coords)
    # prolong and restrict are transposes of each other
    rng = np.random.default_rng(5)
    vc = torch.as_tensor(rng.standard_normal(2 * ph[0].coords.shape[0]))
    vf = torch.as_tensor(rng.standard_normal(2 * ph[1].coords.shape[0]))
    par = torch.as_tensor(ph[1].parents)
    table = torch.as_tensor(pmg.restrict_table(ph[1].parents, ph[0].coords.shape[0]))
    lhs = float(vf @ pmg.prolong(vc, par))
    rhs = float(vc @ pmg.restrict(vf, table, ph[0].coords.shape[0]))
    assert abs(lhs - rhs) <= 1e-12 * abs(lhs)
    want_r = np.asarray(jmg.restrict(jnp.asarray(vf.numpy()), jnp.asarray(ph[1].parents),
                                     ph[0].coords.shape[0]))
    assert np.abs(pmg.restrict(vf, table, ph[0].coords.shape[0]).numpy() - want_r).max() \
        <= 1e-14 * np.abs(want_r).max()
    # one V-cycle on a seeded residual
    jvc, jfree = _jax_mf_vcycle(1)
    pre = tsx._mg_preconditioner(TsxTunnelConfig(solver="mg", refine_levels=1),
                                 tsx.tsx_mesh(refine_levels=1), torch.float64, "cpu")
    r = rng.standard_normal(jfree.shape[0]) * np.asarray(jfree)
    want = np.asarray(jvc(jnp.asarray(r)))
    got = pre(torch.as_tensor(r)).numpy()
    assert np.abs(got - want).max() <= 1e-12 * np.abs(want).max()


def test_w_cycle_matches_jax():
    """One W-cycle on the level-2 assembled hierarchy: the JAX package's
    (its ELL kernels in interpret mode; its slot ones compile for longer
    than a test may take) on its host data, carried over to the port in
    both device formats.  The slot format is the scale preset's: its cycle
    launches K4 and K3's transfers twice on level 1."""
    shear, bulk = SHEAR, BULK
    with np.load(jtsx._DATA) as raw:
        c, e = raw["coords"].astype(np.float64), raw["elems"]
    jarr, jmeta, _, jco = jmg.build_hierarchy_ell(
        c, e, 2, tsx._free_of, shear, bulk, jel.volume_element(jel.ElementType.P1), fmt="ell",
        collect_levels=True)
    idx0 = jco["free_idx0"]
    vc = jmg.make_vcycle_ell(
        jmeta, lambda r: jnp.zeros_like(r).at[idx0].set(jco["inv0"] @ r[idx0]), nu=2, cycle="w")
    host = [dict(lv, inv=np.asarray(a["inv"])) for lv, a in zip(jco["levels"], jarr)]
    hier = {fmt: pmg.hierarchy_to_device(host, jco["inv0"], idx0, "cpu", fmt=fmt)
            for fmt in ("ell", "slot")}
    n = host[-1]["K"].shape[0]
    r = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    want = np.asarray(jax.jit(lambda x: vc(jarr, x))(jnp.asarray(r)))
    got = {}
    for fmt, h in hier.items():
        pspmv.LAUNCHES.clear()
        got[fmt] = pmg.make_vcycle_ell(h, nu=2, cycle="w")(torch.as_tensor(r)).numpy()
        # level 2 once, level 1 twice and its masked residual between: 4 +
        # 2 * 4 + 1 sweeps; R and P of level 2 once, of level 1 twice
        assert pspmv.LAUNCHES == ({"ell_spmv_f32_plain": 13 + 6} if fmt == "ell" else
                                  {"block_jacobi_sweep_plain": 13, "node_transfer_plain": 6})
        # f32 sums in other orders: the slot cycle is 1.0e-6 to 2.8e-6 of
        # the largest entry from the JAX package's over seeds 2-6, against
        # 2.4e-7 to 3.0e-7 for one V-cycle at this level
        # (test_torch_multigrid.py holds V-cycles to 2e-5)
        assert np.abs(got[fmt] - want).max() <= 1e-5 * np.abs(want).max(), fmt
    v = pmg.make_vcycle_ell(hier["slot"], nu=2)(torch.as_tensor(r)).numpy()
    assert np.abs(got["slot"] - v).max() > 1e-3 * np.abs(v).max()  # a different cycle


# ---------------------------------------------------------------------------
# the runs, against the JAX package's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(TSX_OPTIONS))
def test_option_run_matches_jax(name):
    want = fixture(name)
    cfg = config_of(want)
    pspmv.LAUNCHES.clear()
    res, r = run_port(cfg)
    check_run(want, res, r, cfg, hold_cg=name not in ELASTIC_CUTS)
    if cfg.mg_cycle == "w":
        assert pspmv.LAUNCHES["block_jacobi_sweep_plain"] > 0


@pytest.mark.parametrize("gs", [False, True], ids=["mf", "gs"])
def test_p2_on_ell_residual_operators(gs):
    """P2 p-multigrid with G and S (and their f32 heads) in sliced ELL: the
    JAX package's CSR route of the same tangent (`tsx_p2_pmg_mf_z2`, or
    with gs_tangent `tsx_p2_pmg_gs_z2`); no CSR product runs."""
    want = fixture(f"tsx_p2_pmg_{'gs' if gs else 'mf'}_z2")
    cfg = TsxTunnelConfig.fast(etype=pel.ElementType.P2, solver="ell", residual_fmt="ell",
                               gs_tangent=True if gs else None, zeta_max=2 / 17)
    assert cfg.gs_tangent_on == gs
    pspmv.LAUNCHES.clear()
    res, r = run_port(cfg)
    check_run(want, res, r, cfg)
    assert pspmv.LAUNCHES["ell_spmv_f64_plain"] > 0 and pspmv.LAUNCHES["ell_spmv_f32_plain"] > 0
    assert not any(k.startswith("csr_spmv") for k in pspmv.LAUNCHES)


# ---------------------------------------------------------------------------
# chunked runs and checkpoints
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("model", ["tsx", "footing"])
def test_chunked_run_resumes_bitwise_from_its_checkpoint(model, tmp_path):
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig

    mod, cfg = ((tsx, TsxTunnelConfig.fast()) if model == "tsx"
                else (footing, FootingConfig.fast(level=0)))
    run, _ = mod.build_df32(cfg, device="cpu")
    full = run()
    ck = tmp_path / "carry.npz"
    ex1, _ = mod.build_df32_chunked(cfg, trips_per_chunk=3, max_chunks=1, device="cpu")
    r1 = ex1(checkpoint_path=ck)
    assert ck.exists() and r1.n_steps < full.n_steps  # interrupted mid-schedule
    ex2, _ = mod.build_df32_chunked(cfg, trips_per_chunk=3, device="cpu")
    r2 = ex2(checkpoint_path=ck)
    assert (r2.n_steps, r2.n_newton_total) == (full.n_steps, full.n_newton_total)
    assert np.array_equal(np.asarray(r2.u), np.asarray(full.u))
    # without a file the chunks run on from one another, the same bits
    r3 = mod.build_df32_chunked(cfg, trips_per_chunk=4, device="cpu")[0]()
    assert np.array_equal(np.asarray(r3.u), np.asarray(full.u))


def test_jax_checkpoint_resumes_in_the_port():
    """A carry written by the JAX package's `solve/chunked.py` after 3 load
    trips of `fast_scale(1)` is continued by the port to the end of the
    schedule: the JAX package's single run (`tsx_scale_l1`)."""
    want = fixture("tsx_scale_l1")
    extras = {}
    run, mesh = tsx.build_df32(TsxTunnelConfig.fast_scale(1), device="cpu", extras=extras)
    carry = load_checkpoint(FIXTURES / "tsx_scale_l1_ckpt3.npz")
    assert carry["step"] == 3
    res = run(resume=carry)
    r = tsx._df32_result(res, mesh, extras)
    assert (r.n_steps, r.n_newton_total, r.n_plastic) == (
        int(want["n_steps"]), int(want["n_newton_total"]), int(want["n_plastic"]))
    assert rel(r.u, want["u"]) < 1e-9


def test_configs_accept_the_options():
    ok = [
        TsxTunnelConfig(solver="mg", refine_levels=1, cg_structure="scan", mg_nu=3),
        TsxTunnelConfig.fast(solver="mg", refine_levels=0, cg_deflate=4),
        TsxTunnelConfig(etype=pel.ElementType.P4, solver="cg", support_pressure=3.0),
        TsxTunnelConfig.fast_scale(4, mg_cycle="w", cg_deflate=8, cg_structure="scan"),
        TsxTunnelConfig.fast(etype=pel.ElementType.P4, solver="ell", residual_fmt="ell"),
    ]
    assert [c.solver for c in ok] == ["mg", "mg", "cg", "ell", "ell"]
    for kw, exc in [
        (dict(solver="mg", mg_cycle="w"), NotImplementedError),  # matrix-free: V only
        (dict(solver="dense", cg_structure="scan"), NotImplementedError),
        (dict(solver="cg", cg_deflate=4), NotImplementedError),  # native
        (dict(solver="cg", cg_deflate=-1), ValueError),
    ]:
        with pytest.raises(exc):
            TsxTunnelConfig(**kw)
