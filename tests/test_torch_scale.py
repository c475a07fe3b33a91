"""PyTorch port: the scale preset `TsxTunnelConfig.fast_scale` end to end (CPU).

The multigrid-CG path runs on the once- and twice-refined tsx meshes
through its kernels' plain versions and is held to the JAX package's own
output, read from the committed fixtures that `tools/make_port_fixtures.py`
writes (no test re-runs a JAX solve).  The kernels add a row's entries in
another order than the JAX package's slot kernels, so the f32 products
differ in their last bits: steps, Newton iterations and plastic points are
held to equality, the CG total to 5%, the field to 1e-8.
"""
import pathlib

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.ops import spmv
from fem_elastoplasticity_tpu_torch.solve import multigrid as mgm
from fem_elastoplasticity_tpu_torch.solve.newton import carry_of
from fem_elastoplasticity_tpu_torch.utils.convert import carry_from_jax, carry_to_jax

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
ANCHOR_U40_L1 = -2.166787295662e-03  # tests/test_tsx_tunnel.py


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def l1():
    """(build extras, raw result, converted result, launch counts) of level 1."""
    extras = {}
    run, mesh = tsx.build_df32(TsxTunnelConfig.fast_scale(1), device="cpu", extras=extras)
    spmv.LAUNCHES.clear()
    res = run()
    return extras, mesh, res, tsx._df32_result(res, mesh, extras), dict(spmv.LAUNCHES)


def _against_fixture(r, name):
    exp = np.load(FIXTURES / name)
    print(
        f"{name}: port {r.n_steps} steps / {r.n_newton_total} Newton / {r.n_cg_total} CG / "
        f"{r.n_plastic} plastic, JAX {int(exp['n_steps'])} / {int(exp['n_newton_total'])} / "
        f"{int(exp['n_cg_total'])} / {int(exp['n_plastic'])}"
    )
    assert r.n_steps == int(exp["n_steps"])
    assert r.n_newton_total == int(exp["n_newton_total"])
    assert r.n_plastic == int(exp["n_plastic"])
    assert abs(r.n_cg_total - int(exp["n_cg_total"])) <= 0.05 * int(exp["n_cg_total"])
    assert r.u.shape == exp["u"].shape and r.ep.shape == exp["ep"].shape
    assert rel(r.u, exp["u"]) < 1e-8
    n = r.n_steps
    np.testing.assert_allclose(r.zeta_hist[:n], exp["zeta_hist"][:n], rtol=0, atol=1e-7)
    assert rel(r.displ_hist[:n], exp["displ_hist"][:n]) < 1e-8
    return exp


def test_level1_full_schedule_against_jax(l1):
    _, _, _, r, launches = l1
    exp = _against_fixture(r, "tsx_scale_l1.npz")
    assert (r.n_steps, r.n_newton_total, r.n_plastic) == (17, 37, 20)
    assert abs(r.u[40, 0] - ANCHOR_U40_L1) / abs(ANCHOR_U40_L1) < 1e-8
    # the same points yield, in the reference element order
    np.testing.assert_array_equal((r.ep != 0).any(axis=0), (exp["ep"] != 0).any(axis=0))
    assert np.abs(r.ep - exp["ep"]).max() <= 1e-7 * np.abs(exp["ep"]).max()
    # on the CPU every operator application is a plain version
    assert set(launches) == {"node_block_spmv_plain", "node_transfer_plain",
                             "block_jacobi_sweep_plain", "csr_spmv_f64_plain"}
    assert all(v > 0 for v in launches.values())


def test_level1_result_is_in_reference_order(l1):
    """The solve runs on the hierarchy's node ordering with sorted elements;
    `_df32_result` hands u, ep and the mesh back in the reference order, and
    the monitor history was read at the remapped node."""
    extras, mesh, res, r, _ = l1
    ref = tsx.tsx_mesh(refine_levels=1)
    np.testing.assert_array_equal(r.mesh.coords, ref.coords)
    np.testing.assert_array_equal(r.mesh.elems, ref.elems)
    noo = extras["ell_new_of_old"]
    assert extras["monitor_node"] == noo[40] != 40
    np.testing.assert_array_equal(mesh.coords[noo], ref.coords)
    u_perm = res.u.numpy().reshape(-1, 2)
    assert r.u[40, 0] == u_perm[noo[40], 0] == r.displ_hist[16]
    np.testing.assert_array_equal(r.u, u_perm[noo])
    # plastic points: element k of the run is element esort[k] of the
    # permuted reference connectivity
    esort, n_q, n_real = extras["elem_sort"]
    assert (n_q, n_real) == (1, 3548) and r.ep.shape == (4, 3584)
    np.testing.assert_array_equal(mesh.elems, noo[ref.elems][esort])
    np.testing.assert_array_equal(r.ep[:, esort], res.ep.numpy()[:, :n_real])
    assert (r.ep[:, n_real:] == 0).all()


def test_level1_carry_counts_cg(l1):
    """The resume carry holds the CG total, and survives the JAX format."""
    _, _, res, r, _ = l1
    carry = carry_of(res)
    assert carry["ncg_total"] == r.n_cg_total > 0
    back = carry_from_jax(carry_to_jax(carry))
    assert back["ncg_total"] == r.n_cg_total and back["nits_total"] == 37
    # three load trips, then the rest from the carry: the same solve
    run3, _ = tsx.build_df32(TsxTunnelConfig.fast_scale(1, max_trips=3), device="cpu")
    part = run3()
    assert part.n_steps == 3 and 0 < part.n_cg_total < r.n_cg_total
    run, _ = tsx.build_df32(TsxTunnelConfig.fast_scale(1), device="cpu")
    full = run(carry_of(part))
    assert (full.n_steps, full.n_newton_total, full.n_cg_total) == (17, 37, r.n_cg_total)
    assert torch.equal(full.u, res.u)
    # through the JAX format the state is a pair of f32 arrays, some bits
    # short of f64: the same schedule, CG total within a few iterations
    full = run(carry_from_jax(carry_to_jax(carry_of(part))))
    assert (full.n_steps, full.n_newton_total) == (17, 37)
    assert abs(full.n_cg_total - r.n_cg_total) <= 0.05 * r.n_cg_total
    assert rel(full.u.numpy(), res.u.numpy()) < 1e-8


def test_level2_two_steps_against_jax():
    r = tsx.solve(TsxTunnelConfig.fast_scale(2, zeta_max=2 / 17), device="cpu")
    _against_fixture(r, "tsx_scale_l2_2steps.npz")
    assert r.n_steps == 2 and r.u.shape == (7226, 2)


def test_solve_entry_point_equals_build_and_run(l1):
    _, _, _, r, _ = l1
    s = tsx.solve(TsxTunnelConfig.fast_scale(1, zeta_max=1 / 17), device="cpu")
    assert (s.n_steps, s.n_plastic) == (1, 0) and s.n_cg_total > 0
    assert abs(s.displ_hist[0] - r.displ_hist[0]) <= 1e-12 * abs(r.displ_hist[0])


def test_cg_cap_counts_as_divergence():
    """A capped, unconverged tangent solve fails the Newton iteration: with
    one CG iteration allowed no step is ever accepted and d_zeta halves
    until it falls under its floor."""
    r = tsx.solve(TsxTunnelConfig.fast_scale(1, cg_maxiter=1), device="cpu")
    assert r.n_steps == 0 and r.n_newton_total == 4 and float(np.abs(r.u).max()) == 0.0
    # cg_cap_relax accepts capped solves that made progress
    q = tsx.solve(TsxTunnelConfig.fast_scale(1, cg_maxiter=6, cg_cap_relax=0.5, zeta_max=1 / 17),
                  device="cpu")
    assert q.n_steps == 1


# rows of the level-5 hierarchy, coarsest first (the smoke run's setup line)
LEVEL5_ROWS = (952, 3678, 14452, 57288, 228112, 910368)


def test_level5_ell_scatter_is_refused_before_any_assembly():
    """Level 5 in the ELL format with the scatter refresh is refused when
    the config is built, before any assembly: the JAX package cannot run
    that pair either.  Level 5 itself runs (`test_level5_packing_decision`)."""
    with pytest.raises(ValueError, match="gather"):
        tsx.build_df32(TsxTunnelConfig.fast_scale(5, spmv_fmt="ell"), device="cpu")


def test_level5_packing_decision():
    """`pack_bf16="auto"` smooths level 5's fine level (910,368 rows) from
    bf16 values (K5) and every smaller level from f32 (K4), as the JAX
    package decides (`multigrid.py:366-368`); True and False force it."""
    assert [mgm.packs_bf16(n) for n in LEVEL5_ROWS] == [False] * 5 + [True]
    assert mgm.packs_bf16(mgm.PACK_BF16_MIN_ROWS) and not mgm.packs_bf16(mgm.PACK_BF16_MIN_ROWS - 1)
    assert mgm.PACK_BF16_MIN_ROWS == 500_000
    # forced either way, every level or none
    assert all(mgm.packs_bf16(n, True) for n in LEVEL5_ROWS)
    assert not any(mgm.packs_bf16(n, False) for n in LEVEL5_ROWS)
