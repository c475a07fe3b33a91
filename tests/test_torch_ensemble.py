"""PyTorch port: material ensembles (`parallel/ensemble.py`) on the CPU.

The ensembles are held to the JAX package's own output, read from the
fixtures that `tools/make_port_fixtures.py` writes (ensemble_*.npz; no test
runs a JAX ensemble), and each member to the port's single solve of its
material, by the JAX package's gates (`tests/test_parallel.py`).  The
member-batched pieces are held bitwise to their single forms, member by
member: the return maps (the plain version of K2's batched instance and the
f64 lanes), the assembly contractions, and the batched PCG's counts.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.models.materials import (
    dp_return_map_lanes,
    drucker_prager_fit,
    elastic_tangent_lanes,
    lame_moduli,
)
from fem_elastoplasticity_tpu_torch.ops import assembly as asm
from fem_elastoplasticity_tpu_torch.ops import return_map as rm
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType
from fem_elastoplasticity_tpu_torch.parallel import ensemble as ens
from fem_elastoplasticity_tpu_torch.solve import cg
from fem_elastoplasticity_tpu_torch.solve import newton

# tiny tensors: extra threads only contend with the other test workers
torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
CPU = torch.device("cpu")
DEG = np.pi / 180.0


def fixture(name):
    z = dict(np.load(FIXTURES / f"{name}.npz"))
    z["config"] = json.loads(str(z["config"]))
    return z


def grid_of(z):
    # radians as the fixture tool and TsxTunnelConfig's default form them
    return ens.material_grid(z["cohesions"], z["frictions_deg"] * np.pi / 180.0)


@pytest.fixture(scope="module")
def single_df32():
    return tsx.solve(TsxTunnelConfig.fast(), device=CPU)


def test_material_grid_is_bitwise_the_jax_grid():
    from fem_elastoplasticity_tpu.parallel.ensemble import material_grid as jax_grid

    coh, fr = np.linspace(14, 25, 8), np.deg2rad(np.linspace(40, 55, 8))
    for got, want in zip(ens.material_grid(coh, fr), jax_grid(coh, fr)):
        assert got.dtype == np.float64 and np.array_equal(got, np.asarray(want))
    for name in ("ensemble_f64", "ensemble_df32_cg_l1"):
        z = fixture(name)
        eta, c = grid_of(z)
        assert np.array_equal(eta, z["eta"]) and np.array_equal(c, z["c"])
    # member i * n_friction + j is (cohesion i, friction j), the single fit's
    eta, c = ens.material_grid(coh, fr)
    assert (eta[13], c[13]) == drucker_prager_fit(float(coh[1]), float(fr[5]))


def member_inputs(dtype, n=896, seed=7):
    """Seeded strains of three materials (the reference, a weak and a stiff
    one) at three load factors: every branch is hit."""
    rng = np.random.default_rng(seed)
    mats = [drucker_prager_fit(cc, ff * DEG) for cc, ff in ((18.7, 49), (4.0, 40), (25.0, 55))]
    zetas = [float(np.float32(7 / 17)), 0.3, 1.0]
    e3 = torch.as_tensor(rng.normal(0, 2e-3, (3, 3, n)), dtype=dtype)
    ep = torch.as_tensor(rng.normal(0, 2e-4, (3, 4, n)), dtype=dtype)
    e0_dir = torch.as_tensor(rng.normal(0, 1e-3, 4), dtype=dtype)
    params = torch.tensor([[e, c, z] for (e, c), z in zip(mats, zetas)], dtype=torch.float64)
    return mats, zetas, e3, ep, e0_dir, params


@pytest.mark.parametrize("apex", [False, True])
@pytest.mark.parametrize("apply", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_batched_plain_return_map_is_bitwise_single_calls(dtype, apply, apex):
    """K2's member-batched plain version: member b is bitwise the single
    plain version with its eta, c and zeta; the Newton entry on a CPU
    tensor routes to it and counts it."""
    shear, bulk = lame_moduli(60000.0, 0.2)
    mats, zetas, e3, ep, e0_dir, params = member_inputs(dtype)
    got = rm.dp_return_map_plain_batched(e3, ep, shear, bulk, params, e0_dir, apply, apex)
    for b, ((eta, c), zeta) in enumerate(zip(mats, zetas)):
        one = rm.dp_return_map_plain(e3[b], ep[b], shear, bulk, eta, c, e0_dir, zeta, apply, apex)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one))
    assert 0 < int((got[2] > 0).sum()) < got[2].numel()
    rm.LAUNCHES.clear()
    s, D, ind_p, lam, ep_ = rm.dp_return_map_newton_batched(e3, ep, shear, bulk, params, e0_dir,
                                                            apply, apex)
    assert dict(rm.LAUNCHES) == {"dp_return_map_batched_plain": 1}
    assert torch.equal(D, rm.unpack_tangent(got[1])) and torch.equal(ind_p, got[2] > 0.0)
    assert all(torch.equal(a, b) for a, b in zip((s, lam, ep_), (got[0], got[2], got[3])))


@pytest.mark.parametrize("apply", [False, True])
def test_batched_f64_return_map_is_bitwise_single_calls(apply):
    """The f64 lanes return map (df32 and native f64 members) with (B, 1)
    eta and c and e0 = zeta_b e0_dir: member b's bits are a call with its
    Python floats."""
    shear, bulk = lame_moduli(60000.0, 0.2)
    mats, zetas, e3, ep, e0_dir, params = member_inputs(torch.float64, seed=11)
    e0 = (e0_dir[None, :] * params[:, 2:3])[..., None]
    got = dp_return_map_lanes(e3, ep, shear, bulk, params[:, 0:1], params[:, 1:2], e0=e0,
                              apply_plastic_strain=apply)
    for b, ((eta, c), zeta) in enumerate(zip(mats, zetas)):
        one = dp_return_map_lanes(e3[b], ep[b], shear, bulk, eta, c, e0=e0_dir * zeta,
                                  apply_plastic_strain=apply)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one))


@pytest.mark.parametrize("etype", [ElementType.P1, ElementType.P2])
def test_batched_assembly_is_bitwise_single_calls(etype):
    """strains, internal_force, tangent_matvec, element_stiffness,
    assemble_dense_free, node_block_diagonal, plastic_slots and
    plastic_correction_gather with a member axis over one geometry."""
    p = tsx._problem(TsxTunnelConfig(etype=etype), CPU, torch.float64)
    g, rng = p.geom, np.random.default_rng(3)
    u = torch.as_tensor(rng.normal(size=(3, 2 * g.n_nodes)))
    s3 = torch.as_tensor(rng.normal(size=(3, 3, g.n_int)))
    d = torch.as_tensor(rng.normal(size=(3, 3, 3, g.n_int)))
    ind = torch.as_tensor(rng.random((3, g.n_int)) < 0.05)
    smap = asm.node_slot_map(g)
    ke = asm.element_stiffness(g, d)
    got = dict(strains=asm.strains(g, u), force=asm.internal_force(g, s3),
               matvec=asm.tangent_matvec(g, d, u), ke=ke,
               K=asm.assemble_dense_free(ke, p.plan), blocks=asm.node_block_diagonal(g, d, smap))
    idx, valid = asm.plastic_slots(ind, 64)
    gathered = asm.plastic_correction_gather(g, d, idx, valid)
    for b in range(3):
        ke1 = asm.element_stiffness(g, d[b])
        want = dict(strains=asm.strains(g, u[b]), force=asm.internal_force(g, s3[b]),
                    matvec=asm.tangent_matvec(g, d[b], u[b]), ke=ke1,
                    K=asm.assemble_dense_free(ke1, p.plan),
                    blocks=asm.node_block_diagonal(g, d[b], smap))
        assert all(torch.equal(got[k][b], want[k]) for k in want)
        i1, v1 = asm.plastic_slots(ind[b], 64)
        assert torch.equal(idx[b], i1) and torch.equal(valid[b], v1)
        one = asm.plastic_correction_gather(g, d[b], i1, v1)
        assert all(torch.equal(x[b], y) for x, y in zip(gathered, one))


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_batched_cg_follows_each_members_single_solve(dtype):
    """Three tangents with their own tolerances: each member takes its
    single solve's iterations and converges with it; the solution agrees
    to the tolerance (the batched inner products sum in another order)."""
    p = tsx._problem(TsxTunnelConfig(solver="cg"), CPU, dtype)
    g = p.geom
    free = torch.as_tensor(p.mesh.free.reshape(-1))
    shear, bulk = lame_moduli(60000.0, 0.2)
    d = elastic_tangent_lanes(shear, bulk, g.n_int, dtype).expand(3, 3, 3, g.n_int).clone()
    d[1] *= 1.5
    d[2, :, :, :200] *= 0.25
    b = torch.as_tensor(np.random.default_rng(5).normal(size=(3, 2 * g.n_nodes)), dtype=dtype)
    tols = [1e-5, 2e-7, 1e-4] if dtype == torch.float32 else [1e-10, 1e-12, 1e-9]
    smap = asm.node_slot_map(g)
    res = cg.solve_cg_members(
        lambda v: asm.tangent_matvec(g, d, v), b, free,
        precond=cg.block_jacobi_preconditioner(asm.node_block_diagonal(g, d, smap), free),
        tol=torch.tensor(tols, dtype=dtype), maxiter=2000)
    for m in range(3):
        one = cg.solve_cg(
            lambda v: asm.tangent_matvec(g, d[m], v), b[m], free,
            precond=cg.block_jacobi_preconditioner(asm.node_block_diagonal(g, d[m], smap), free),
            tol=tols[m], maxiter=2000)
        assert int(res.iters[m]) == one.iters and bool(res.converged[m]) and one.converged
        assert float((res.x[m] - one.x).abs().max() / one.x.abs().max()) < 50 * tols[m]
    assert res.host_reads == int(res.iters.max()) + 1


def test_f64_ensemble_matches_jax_and_single_solves():
    """JAX `test_vmap_matches_individual_solves`: the (18.7, 49 deg) member
    within 1e-12 of the single f64 solve with its step count, each member
    within 1e-12 of the JAX ensemble with its counts."""
    z = fixture("ensemble_f64")
    eta, c = grid_of(z)
    e = ens.solve_tsx_ensemble(eta, c, device=CPU)
    assert e.u.shape == (2, 476, 2)
    ref = tsx.solve(TsxTunnelConfig(), device=CPU)
    np.testing.assert_allclose(e.u[1], ref.u, rtol=0, atol=1e-12)
    assert int(e.n_steps[1]) == ref.n_steps and int(e.n_newton_total[1]) == ref.n_newton_total
    for k in ("n_steps", "n_newton_total", "n_plastic"):
        np.testing.assert_array_equal(getattr(e, k), z[k])
    np.testing.assert_allclose(e.u, z["u"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(e.zeta_hist, z["zeta_hist"], rtol=0, atol=1e-15)
    np.testing.assert_allclose(e.monitor_hist, z["monitor_hist"], rtol=0, atol=1e-12)
    # JAX `test_weaker_material_yields_more`
    assert e.n_plastic[0] >= e.n_plastic[1]
    assert abs(e.monitor_hist[0, 16]) >= abs(e.monitor_hist[1, 16])


def test_df32_member_matches_single_df32_solve(single_df32):
    """JAX `test_member_matches_single_df32_solve`: the reference material
    takes 17 steps and the single solve's Newton count, u within 1e-15 (the
    ensemble's Woodbury runs 128 slots, the single solve's 64); the stiffer
    member stays elastic.  Both members against the JAX ensemble."""
    z = fixture("ensemble_df32")
    e = ens.solve_tsx_ensemble_df32(*grid_of(z), device=CPU)
    assert int(e.n_steps[0]) == 17 and int(e.n_newton_total[0]) == single_df32.n_newton_total
    np.testing.assert_allclose(e.u[0], single_df32.u, rtol=0, atol=1e-15)
    assert int(e.n_plastic[1]) == 0
    for k in ("n_steps", "n_newton_total", "n_plastic"):
        np.testing.assert_array_equal(getattr(e, k), z[k])
    np.testing.assert_allclose(e.u, z["u"], rtol=0, atol=1e-15)
    # JAX records the float32 head of its two-float zeta, the port a float64
    np.testing.assert_array_equal(e.zeta_hist.astype(np.float32),
                                  z["zeta_hist"].astype(np.float32))


def test_weak_df32_member_batches_cleanly(single_df32):
    """JAX `test_weak_member_batches_cleanly`: cohesion 4 (77 plastic
    points, past no cap) reaches zeta = 1 beside the reference member,
    which stays the single solve's."""
    z = fixture("ensemble_df32_weak")
    e = ens.solve_tsx_ensemble_df32(*grid_of(z), device=CPU)
    assert np.isfinite(e.u).all()
    assert int(e.n_plastic[0]) > 50
    assert float(e.zeta_hist[0].max()) >= 1.0
    np.testing.assert_allclose(e.u[1], single_df32.u, rtol=0, atol=1e-15)
    for k in ("n_steps", "n_newton_total", "n_plastic"):
        np.testing.assert_array_equal(getattr(e, k), z[k])
    np.testing.assert_allclose(e.u, z["u"], rtol=0, atol=1e-15)


def test_refined_cg_members_match_single_solve():
    """JAX `test_refined_cg_members_match_single_solve`: four members at
    refine level 1 on matrix-free PCG, cut at zeta 2/17; the (18.7, 49 deg)
    member within 1e-14 (relative) of the single df32 CG solve, and every
    member within it of the JAX ensemble."""
    z = fixture("ensemble_df32_cg_l1")
    cfg_kw = {k: v for k, v in z["config"].items() if k != "df32"}
    cfg = TsxTunnelConfig.fast(**cfg_kw)
    e = ens.solve_tsx_ensemble_df32(*grid_of(z), cfg=cfg, device=CPU)
    r1 = tsx.solve(cfg, device=CPU)
    assert np.abs(e.u[3] - r1.u).max() < 1e-14 * np.abs(r1.u).max()
    assert int(e.n_plastic[0]) >= int(e.n_plastic[3])
    for k in ("n_steps", "n_newton_total", "n_plastic"):
        np.testing.assert_array_equal(getattr(e, k), z[k])
    # the JAX run's state is two-float (about 2^-48 relative), the port's f64
    assert np.abs(e.u - z["u"]).max() < 1e-13 * np.abs(z["u"]).max()


def test_f32_members_follow_their_single_solves():
    """Native f32 (K2's batched plain version here): each member takes its
    single f32 solve's steps and Newton iterations, u within 1e-5
    (relative); the weak member factors afresh while the other reuses the
    shared elastic factor.  One return-map call a sweep, and one for each
    sweep that accepts steps."""
    coh = (4.0, 18.7)
    eta, c = ens.material_grid(np.array(coh), np.array([49.0 * DEG]))
    rm.LAUNCHES.clear()
    e = ens.solve_tsx_ensemble(eta, c, TsxTunnelConfig.fast_f32(), device=CPU)
    calls = rm.LAUNCHES["dp_return_map_batched_plain"]
    assert set(rm.LAUNCHES) == {"dp_return_map_batched_plain"}
    for b, cc in enumerate(coh):
        r = tsx.solve(TsxTunnelConfig.fast_f32(cohesion=cc), device=CPU)
        assert (int(e.n_steps[b]), int(e.n_newton_total[b]), int(e.n_plastic[b])) == (
            r.n_steps, r.n_newton_total, r.n_plastic)
        assert np.abs(e.u[b] - r.u).max() <= 1e-5 * np.abs(r.u).max()
    sweeps = int(e.n_newton_total.max())
    assert sweeps < calls <= 2 * sweeps


def test_native_cg_members_follow_their_single_solves():
    """Native f64 block-Jacobi PCG members, cut at zeta 13/17 (both
    plastic from step 12 or 13): steps and Newton counts of each member's
    single CG solve, u within 1e-12 (the ensemble's predictor is a
    Cholesky solve, the single solve's a PCG one)."""
    coh = (12.0, 15.0)
    cfg = TsxTunnelConfig(solver="cg", zeta_max=13 / 17)
    eta, c = ens.material_grid(np.array(coh), np.array([49.0 * DEG]))
    e = ens.solve_tsx_ensemble(eta, c, cfg, device=CPU)
    for b, cc in enumerate(coh):
        r = tsx.solve(TsxTunnelConfig(solver="cg", zeta_max=13 / 17, cohesion=cc), device=CPU)
        assert (int(e.n_steps[b]), int(e.n_newton_total[b]), int(e.n_plastic[b])) == (
            r.n_steps, r.n_newton_total, r.n_plastic)
        assert r.n_plastic > 0
        np.testing.assert_allclose(e.u[b], r.u, rtol=0, atol=1e-12 * np.abs(r.u).max())


@pytest.mark.parametrize("df32", [False, True])
def test_member_that_ends_first_stays_frozen(df32):
    """The stiff member (cohesion 25) ends after 17 sweeps; beside it one
    partner runs on to about 35 Newton iterations (cohesion 15), another
    to about 70 (cohesion 4).  While both run, the batch has the same
    shapes, so the stiff member's result is bitwise the same beside either
    partner only if the later sweeps leave it untouched."""
    run = ens.solve_tsx_ensemble_df32 if df32 else ens.solve_tsx_ensemble
    out = []
    for partner in (15.0, 4.0):
        eta, c = ens.material_grid(np.array([25.0, partner]), np.array([49.0 * DEG]))
        out.append(run(eta, c, device=CPU))
    assert out[0].n_newton_total[0] == 17 < out[0].n_newton_total[1] < out[1].n_newton_total[1]
    for k in ens.EnsembleResult._fields:
        np.testing.assert_array_equal(getattr(out[0], k)[0], getattr(out[1], k)[0])


def test_stepper_counts_sweeps_and_reads():
    """The flat sweep: as many sweeps as the largest member Newton total,
    one read each on the df32 dense path, each member's trips its own."""
    cfg = TsxTunnelConfig.fast()
    p = tsx._problem(cfg, CPU)
    shear, bulk = p.consts[:2]
    eta, c = ens.material_grid(np.array([4.0, 18.7, 25.0]), np.array([49.0 * DEG]))
    geom32 = p.geom.to(torch.float32)
    from fem_elastoplasticity_tpu_torch.ops import assembly_df as adf

    L, Ki = adf.dense_elastic_factors(
        geom32, elastic_tangent_lanes(shear, bulk, p.geom.n_int, torch.float32), p.plan)
    u_el = adf.refine_elastic_solve_df(
        L, p.free_idx, lambda u: adf.elastic_apply(p.geom, u, shear, bulk),
        torch.zeros(2 * p.geom.n_nodes, dtype=torch.float64), -tsx._initial_force(p))
    run = newton.build_ensemble_stepper(
        p.geom, p.free_idx, p.plan, shear, bulk, eta, c, p.settings,
        monitor=tsx._monitor(cfg.monitor_node), e0_dir=p.e0, elastic_factor=("inv", Ki),
        smw_cap=128, precision="df32")
    res = run(u_el * cfg.d_zeta, cfg.d_zeta)
    assert res.sweeps == int(res.n_newton_total.max()) == res.host_reads
    assert [sum(t) for t in res.newton_trips] == list(res.n_newton_total)
    assert [len(t) for t in res.newton_trips] == [17, 17, 17]
    assert res.newton_trips[2] == (1,) * 17  # the stiff member stays elastic


def test_refusals():
    eta, c = ens.material_grid(np.array([18.7]), np.array([49.0 * DEG]))
    # the multi-device refusals of the JAX package: a bf16-packed hierarchy
    # (its smoother has no row-sharded form), the tsx off solver="ell", the
    # footing without its tangent multigrid
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
    from fem_elastoplasticity_tpu_torch.ops.elements import volume_element
    from fem_elastoplasticity_tpu_torch.parallel.sharding import ShardGroup
    from fem_elastoplasticity_tpu_torch.solve import multigrid as mgm

    shear, bulk = lame_moduli(TsxTunnelConfig().young, TsxTunnelConfig().poisson)
    with np.load(tsx._DATA) as raw:
        packed, _, _ = mgm.build_hierarchy_ell(
            raw["coords"].astype(np.float64), raw["elems"], 1, tsx._free_of, shear, bulk,
            volume_element(ElementType.P1), device=CPU, pack_bf16=True)
    with pytest.raises(NotImplementedError, match="bf16-packed"):
        mgm.shard_hierarchy_ell(packed, ShardGroup(0, 2, CPU, "gloo"))
    with pytest.raises(ValueError, match="solver='ell'"):
        tsx.build_df32(TsxTunnelConfig.fast(solver="cg"), device=CPU, shard_devices=2)
    with pytest.raises(ValueError, match="tangent_mg"):
        footing.build_df32(FootingConfig.fast(), device=CPU, shard_devices=2)
    with pytest.raises(NotImplementedError):
        ens.solve_tsx_ensemble_df32(eta, c, TsxTunnelConfig.fast_scale(1), device=CPU)
    with pytest.raises(NotImplementedError):
        ens.solve_tsx_ensemble_df32(eta, c, TsxTunnelConfig.fast(assembled_cg=True), device=CPU)
    with pytest.raises(NotImplementedError):
        ens.solve_tsx_ensemble(eta, c, solver="mg", device=CPU)
    with pytest.raises(NotImplementedError):
        ens.solve_tsx_ensemble(eta, c, TsxTunnelConfig(dense_mode="mixed"), device=CPU)
    with pytest.raises(ValueError):  # df32 members have their own entry
        ens.solve_tsx_ensemble(eta, c, TsxTunnelConfig.fast(), device=CPU)
    with pytest.raises(ValueError):
        ens.solve_tsx_ensemble_df32(eta, c, TsxTunnelConfig(), device=CPU)
    with pytest.raises(ValueError):
        ens.solve_tsx_ensemble(eta, c[:0], device=CPU)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):  # no device given: the card, and there is none
            ens.solve_tsx_ensemble(eta, c)
