"""PyTorch port: the footing's tangent-multigrid scale path (CPU).

`FootingConfig.fast_scale` end to end through its kernels' plain versions:
the per-Newton-iteration refresh of every hierarchy level
(`solve.multigrid.refresh_hierarchy` / `tangent_vcycle`), the deflated CG
solves and the damped Newton steps, against the JAX package (its
`tangent_vcycle` run here in interpret mode, its solves read from the
fixtures of `tools/make_port_fixtures.py`), and the three ways of resuming
a run.  The port's df32 state is f64 and its products add in other orders,
so trips are held to the JAX run's Newton counts (equal, or fewer on a
trip at the two-float criterion floor, `footing.newton_trip_gaps`), CG to
5% in total, the accepted load factors to 1e-12 and the pressures to 1e-5.
"""
import functools
import pathlib

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
from fem_elastoplasticity_tpu_torch.models.materials import (dp_return_map_lanes,
                                                             drucker_prager_fit,
                                                             elastic_tangent_lanes,
                                                             lame_moduli)
from fem_elastoplasticity_tpu_torch.mesh.structured import square_mesh
from fem_elastoplasticity_tpu_torch.ops import assembly as asm
from fem_elastoplasticity_tpu_torch.ops import spmv
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element
from fem_elastoplasticity_tpu_torch.solve import multigrid as mgm
from fem_elastoplasticity_tpu_torch.utils.convert import load_checkpoint

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
SHEAR, BULK = lame_moduli(1e7, 0.48)
# the plain versions of the path's kernels: K1, K3 (product, transfers and
# the CSR kernel of the Galerkin maps) and K4
PATH_PLAIN = ("csr_spmv_f64_plain", "csr_spmv_f32_plain", "node_block_spmv_plain",
              "node_transfer_plain", "block_jacobi_sweep_plain")
RUNS = {
    "footing_scale_l2_t3": lambda: FootingConfig.fast_scale(2, max_trips=3),
    "footing_scale_l2_damped_t3": lambda: FootingConfig.fast_scale(2, max_trips=3,
                                                                   newton_damping=3),
}
_RUNS = {}


def _run(name):
    """(config, result, launch counts) of a fixture's configuration, once."""
    if name not in _RUNS:
        cfg = RUNS[name]()
        run, _ = footing.build_df32(cfg, device="cpu")
        spmv.LAUNCHES.clear()
        _RUNS[name] = cfg, run(), dict(spmv.LAUNCHES)
    return _RUNS[name]


@pytest.fixture(scope="module")
def l2():
    """extras of the level-2 build: host levels, hierarchy, tangent tables."""
    extras = {}
    footing.build_df32(FootingConfig.fast_scale(2), device="cpu", extras=extras)
    return extras


def _seeded_tangent(n_int: int, seed: int = 0) -> torch.Tensor:
    """A softened elastic tangent, (3, 3, n_int) f32: SPD, other at every point."""
    rng = np.random.default_rng(seed)
    d = elastic_tangent_lanes(SHEAR, BULK, n_int, torch.float32)
    return d * torch.as_tensor(1.0 - 0.5 * rng.random((1, 1, n_int)), dtype=torch.float32)


def test_refresh_at_the_elastic_tangent_reproduces_the_hierarchy(l2):
    """At d = d_elastic the refresh gives the built values on every level
    (the fine level exactly, the Galerkin levels to f32 rounding) and the
    built smoother constants, twice in a row: every refresh starts from the
    elastic values, which it never writes."""
    hier, th = l2["hierarchy"], l2["tangent"]
    before = [lev.sweep_op.block_values.clone() for lev in hier.levels]
    d_el = elastic_tangent_lanes(SHEAR, BULK, th.geom.n_int, torch.float32)
    first = mgm.refresh_hierarchy(th, hier, d_el, SHEAR, BULK)
    second = mgm.refresh_hierarchy(th, hier, d_el, SHEAR, BULK)
    assert len(first.levels) == len(hier.levels) == 2
    for l, (a, b, lev) in enumerate(zip(first.levels, second.levels, hier.levels)):
        assert torch.equal(lev.sweep_op.block_values, before[l])
        assert torch.equal(a.sweep_op.block_values, b.sweep_op.block_values)
        got, want = a.sweep_op.block_values, lev.sweep_op.block_values
        scale = float(want.abs().max())
        if l == len(hier.levels) - 1:
            assert torch.equal(got, want)
        else:
            assert float((got - want).abs().max()) <= 4e-7 * scale
        for f in ("msf", "mpr"):
            e = getattr(lev.aux, f)
            assert float((getattr(a.aux, f) - e).abs().max()) <= 1e-6 * float(e.abs().max())
        assert torch.equal(a.aux.mask, lev.aux.mask)
    assert torch.equal(first.inv0, second.inv0)
    assert float((first.inv0 - hier.inv0).abs().max()) <= 1e-3 * float(hier.inv0.abs().max())


@pytest.fixture(scope="module")
def jax_l2():
    """The JAX package's level-2 hierarchy and tangent tables (slot format,
    f32 values), built as its `models/footing.py` builds them."""
    jax = pytest.importorskip("jax")
    from fem_elastoplasticity_tpu.ops.elements import ElementType as JE
    from fem_elastoplasticity_tpu.ops.elements import volume_element as jvolume
    from fem_elastoplasticity_tpu.solve import multigrid as jmg

    cfg = FootingConfig.fast_scale(2)
    base = square_mesh(1, cfg.etype, cfg.size_xy)
    arr, metas, _, coarse = jmg.build_hierarchy_ell(
        base.coords, base.elems, 1, functools.partial(footing._free_mask, cfg), SHEAR, BULK,
        jvolume(JE.P1), fmt="slot", pack_bf16=False, collect_levels=True)
    ta, ts = jmg.build_tangent_hierarchy(metas, coarse, jvolume(JE.P1))
    return jax, jmg, metas, arr, ta, ts, coarse


def _closure(fn, name):
    """The value that `fn` closes over under `name`."""
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_refreshed_vcycle_matches_jax(l2, jax_l2, seed):
    """The refreshed V-cycle and CG operator at level 2 on a seeded tangent
    against the JAX package's `tangent_vcycle` on the same tangent and
    residual (its slot kernels in interpret mode), stage by stage.

    The refreshed operator agrees to f32 rounding (8.7e-8 of its largest
    entry measured).  What differs is the coarsest level's explicit f32
    inverse: each side factors the Jacobi-scaled coarse matrix (condition
    number ~5.8e3) in f32 with its own library, and over seeds 0-9 the
    port's inverse lies 2.7e-6 to 7.0e-6 from the f64 inverse of the same
    f32 values, the JAX package's 5.0e-6 to 1.9e-5.  With the JAX package's
    inverse put in its place, the port's V-cycle equals JAX's to 1e-6
    (2.2e-7 to 5.2e-7 measured over seeds 0-9).  Each with its own
    inverse, the two V-cycles differ by the sum of the two inverses'
    rounding: 1.2e-5 to 2.25e-5 measured over seeds 0-9, held to 3e-5."""
    jax, jmg, metas, arr, ta, ts, coarse = jax_l2
    jnp = jax.numpy
    assert np.array_equal(np.asarray(coarse["levels"][-1]["elems"]),
                          np.asarray(l2["host_levels"][-1]["elems"]))
    th, hier = l2["tangent"], l2["hierarchy"]
    d = _seeded_tangent(th.geom.n_int, seed)
    r = torch.as_tensor(
        np.random.default_rng(seed + 1).standard_normal(hier.levels[-1].free.shape[0]),
        dtype=torch.float32)
    j_op, j_pre = jmg.tangent_vcycle(metas, arr, ta, ts, jnp.asarray(d.numpy()), SHEAR, BULK)
    op, pre = mgm.tangent_vcycle(th, hier, d, SHEAR, BULK)
    refreshed = mgm.refresh_hierarchy(th, hier, d, SHEAR, BULK)
    # the JAX V-cycle's coarse inverse, from the closures of its V-cycle
    coarse_solve = _closure(_closure(_closure(j_pre, "vc"), "vcycle"), "coarse_solve")
    ki_jax = torch.as_tensor(np.asarray(_closure(coarse_solve, "Ki")))

    def gap(ours, theirs):
        theirs = np.asarray(theirs, np.float64)
        return float(np.abs(np.asarray(ours, np.float64) - theirs).max() / np.abs(theirs).max())

    z_jax = j_pre(jnp.asarray(r.numpy()))
    assert gap(op(r).numpy(), j_op(jnp.asarray(r.numpy()))) <= 1e-6
    same_inverse = mgm.make_vcycle_ell(refreshed._replace(inv0=ki_jax))(r)
    assert gap(same_inverse.numpy(), z_jax) <= 1e-6
    # the port's coarse inverse against the f64 inverse of its f32 values
    n0 = th.n_free0
    K0 = torch.zeros(n0 * n0, dtype=torch.float64)
    K0[th.d0_idx] = refreshed.levels[0].sweep_op.block_values.reshape(-1)[th.pos0_ff].double()
    assert gap(refreshed.inv0.numpy(), torch.linalg.inv(K0.reshape(n0, n0)).numpy()) <= 1e-5
    assert gap(pre(r).numpy(), z_jax) <= 3e-5


@pytest.mark.parametrize("name", list(RUNS))
def test_fast_scale_level2_against_jax(name):
    """fast_scale(2) for three load trips, undamped and with
    newton_damping=3, against the JAX package's run of the same
    configuration, through the plain versions of K1, K3 and K4."""
    cfg, r, launches = _run(name)
    exp = np.load(FIXTURES / f"{name}.npz")
    print(f"{name}: port {r.n_steps} steps / {r.newton_trips} Newton / {r.n_cg_total} CG, "
          f"JAX {int(exp['n_steps'])} / {tuple(exp['newton_trips'])} / {int(exp['n_cg_total'])}")
    assert r.n_steps == int(exp["n_steps"])
    assert footing.newton_trip_gaps(r, exp["newton_trips"], cfg) == []
    assert abs(r.n_cg_total - int(exp["n_cg_total"])) <= 0.05 * int(exp["n_cg_total"])
    np.testing.assert_allclose(r.zeta_trips, exp["zeta_trips"], rtol=0, atol=1e-12)
    n = r.n_steps + 1
    # the JAX package records the f32 head of zeta
    assert np.array_equal(r.zeta_hist[:n].astype(np.float32), exp["zeta_hist"][:n].astype(np.float32))
    p, p_jax = r.pressure_hist[1:n], exp["pressure_hist"][1:n]
    assert np.abs(p - p_jax).max() <= 1e-5 * np.abs(p_jax).max()
    assert r.u.shape == exp["u"].shape == (1681, 2) and r.ep.shape == exp["ep"].shape
    assert np.abs(r.u - exp["u"]).max() <= 1e-8 * np.abs(exp["u"]).max()
    assert r.carry["defl_w"].shape == (3362, 16) and r.carry["defl_w"].dtype == torch.float32
    for k in PATH_PLAIN:
        assert launches.get(k, 0) > 0, (k, launches)


def test_own_carry_resumes_bit_for_bit():
    """Three trips straight, and one trip three times from the carry, give
    the same state bit for bit, deflation basis included."""
    _, straight, _ = _run("footing_scale_l2_t3")
    run, _ = footing.build_df32(FootingConfig.fast_scale(2, max_trips=1), device="cpu")
    r = run()
    for _ in range(2):
        r = run(resume=r.carry)
    assert (r.n_steps, r.n_newton_total, r.n_cg_total) == (
        straight.n_steps, straight.n_newton_total, straight.n_cg_total)
    assert np.array_equal(r.u, straight.u) and np.array_equal(r.ep, straight.ep)
    assert np.array_equal(r.pressure_hist, straight.pressure_hist)
    assert torch.equal(r.carry["defl_w"], straight.carry["defl_w"])
    assert r.carry["defl_ring"] == straight.carry["defl_ring"]


def test_jax_carry_resumes_to_jax_counts():
    """The JAX package's carry after two trips (deflation ring included),
    resumed in the port for one trip, reaches the JAX run's three-trip
    counts and pressure."""
    cfg = FootingConfig.fast_scale(2, max_trips=1)
    exp = np.load(FIXTURES / "footing_scale_l2_t3.npz")
    carry = load_checkpoint(FIXTURES / "footing_scale_l2_ckpt2.npz")
    run, _ = footing.build_df32(cfg, device="cpu")
    r = run(resume=carry)
    n0, cg0 = carry["nits_total"], carry["ncg_total"]
    assert (n0, cg0) == (int(exp["newton_trips"][:2].sum()), int(exp["cg_trips"][:2].sum()))
    assert r.n_steps == int(exp["n_steps"])
    assert footing.newton_trip_gaps(r, exp["newton_trips"][2:], cfg) == []
    assert abs((r.n_cg_total - cg0) - int(exp["cg_trips"][2])) <= 0.05 * int(exp["cg_trips"][2])
    assert r.zeta_trips[0] == pytest.approx(float(exp["zeta_trips"][2]), abs=1e-12)
    n = r.n_steps
    assert abs(r.pressure_hist[n] - exp["pressure_hist"][n]) <= 1e-5 * exp["pressure_hist"][n]


def test_banked_level5_checkpoint_converts_and_holds_its_pressure():
    """checkpoints/footing_l5_k16.npz loads with every key; its u and ep fit
    the port's level-5 mesh, and the footing pressure of sigma = D(eps(u) -
    ep) on that mesh is the last recorded one."""
    cfg = FootingConfig.fast_scale(5)
    carry = load_checkpoint(ROOT / "checkpoints" / "footing_l5_k16.npz")
    assert set(carry) == {"u", "u_old", "u_it", "ep", "zeta_old", "d_zeta", "d_zeta_old",
                          "step", "aux", "zeta_hist", "monitor_hist", "nits_total",
                          "ncg_total", "defl_w", "defl_ring"}
    mesh = footing.tangent_mg_mesh(cfg)
    assert carry["u"].shape == (2 * mesh.n_nodes,) == (206082,)
    assert carry["ep"].shape == (4, mesh.n_elems) == (4, 204800)
    assert carry["defl_w"].shape == (206082, 16) and carry["defl_w"].dtype == torch.float32
    assert 0 <= carry["defl_ring"] < 16
    geom = asm.compute_geometry(torch.as_tensor(mesh.coords), mesh.elems,
                                volume_element(cfg.etype))
    e = asm.strains(geom, carry["u"])
    et = torch.stack([e[0], e[1], e[2], torch.zeros_like(e[0])]) - carry["ep"]
    tr = et[0] + et[1] + et[3]
    s_yy = 2.0 * SHEAR * (et[1] - tr / 3.0) + BULK * tr
    p_node = asm.project_to_nodes(geom, s_yy, asm.node_gather_map(geom))
    foot = torch.as_tensor(mesh.dirichlet[:, 1] > 0)
    pressure = float(-p_node[foot].sum()) / (int(foot.sum()) * cfg.cohesion)
    # the history's last written entry: index step - 1 (the step counter
    # names the next one)
    recorded = float(carry["monitor_hist"][carry["step"] - 1])
    assert abs(pressure - recorded) <= 1e-5 * recorded
    assert carry["zeta_hist"][carry["step"] - 1] == pytest.approx(carry["zeta_old"], abs=1e-7)


def test_returned_stress_is_elastic_in_the_final_strain_on_every_branch():
    """With bug_compatible_apex=False the return map's stress is D(e - ep')
    on the elastic, smooth and apex branches (JAX `models/materials.py:225-
    247`), which the pressure check above relies on; the reference's apex
    strain from the trial strain breaks it on the apex."""
    eta, c = drucker_prager_fit(450.0, float(np.pi / 9))
    rng = np.random.default_rng(3)
    e3 = torch.as_tensor(rng.standard_normal((3, 3000)) * 4e-4)
    e3[:2, :1000] += 2e-3  # volumetric extension: the apex
    ep = torch.as_tensor(rng.standard_normal((4, 3000)) * 1e-5)
    for bug in (False, True):
        s, _, ind_p, _, ep_new = dp_return_map_lanes(e3, ep, SHEAR, BULK, eta, c,
                                                     apply_plastic_strain=True,
                                                     apex_ep_uses_trial=bug)
        et = torch.stack([e3[0], e3[1], e3[2], torch.zeros_like(e3[0])]) - ep_new
        tr = et[0] + et[1] + et[3]
        d_s = torch.stack([2 * SHEAR * (et[0] - tr / 3) + BULK * tr,
                           2 * SHEAR * (et[1] - tr / 3) + BULK * tr, SHEAR * et[2],
                           2 * SHEAR * (et[3] - tr / 3) + BULK * tr])
        gap = (d_s - s).abs().max(dim=0).values / s.abs().max()
        apex = (s[0] == s[1]) & (s[2] == 0) & ind_p
        smooth = ind_p & ~apex
        assert int(apex.sum()) > 0 and int(smooth.sum()) > 0 and int((~ind_p).sum()) > 0
        assert float(gap[~apex].max()) < 1e-12
        assert (float(gap[apex].max()) < 1e-12) != bug


def test_tangent_mg_mesh_is_the_hierarchys_fine_level(l2):
    cfg = FootingConfig.fast_scale(2)
    mesh, fine = footing.tangent_mg_mesh(cfg), l2["host_levels"][-1]
    assert np.array_equal(mesh.coords, fine["coords"]) and np.array_equal(mesh.elems, fine["elems"])
    assert np.array_equal(mesh.free, fine["free"])
    # the lattice of square_mesh(2), other numbers
    ref = footing.build_mesh(cfg)
    assert {tuple(x) for x in mesh.coords} == {tuple(x) for x in ref.coords}
    assert int(mesh.free.sum()) == int(ref.free.sum())
    assert int((mesh.dirichlet > 0).sum()) == int((ref.dirichlet > 0).sum())


def test_galerkin_maps_have_the_restriction_shape(l2):
    """Mhat maps level 1's node-block values onto level 0's: at most four
    coarse entries a fine one, weights products of 0.5 and 1."""
    th, hier = l2["tangent"], l2["hierarchy"]
    (M,) = th.mhat
    assert M.shape == (hier.levels[0].sweep_op.block_values.numel(),
                       hier.levels[1].sweep_op.block_values.numel())
    counts = torch.bincount(M.indices.long(), minlength=M.shape[1])
    assert int(counts.max()) <= 4
    assert set(np.unique(M.values.numpy()).tolist()) <= {0.25, 0.5, 1.0}


@pytest.mark.parametrize("kw,err", [
    # the tangent hierarchy is a P1 hierarchy (JAX `solve/multigrid.py:493`)
    (dict(etype=ElementType.Q2), NotImplementedError),
    (dict(residual_fmt="ell"), NotImplementedError),
    (dict(assembled_cg=True), NotImplementedError),
    (dict(level=1), ValueError),
], ids=lambda v: str(v))
def test_scale_preset_refusals(kw, err):
    level = kw.pop("level", 3)
    with pytest.raises(err):
        FootingConfig.fast_scale(level, **kw)
