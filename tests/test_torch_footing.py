"""PyTorch port: the strip footing (benchmark B) on the CPU.

The mesh and the footing's assembly helpers are held to the JAX package on
seeded inputs; the solves are held to the reference's pressure curve and to
the JAX package's own output, read from the committed fixtures that
`tools/make_port_fixtures.py` writes (no test re-runs a JAX solve).
"""
import pathlib

import jax
import jax.numpy as jnp
import jax.scipy.linalg as jsl
import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu.models import footing as jfoot
from fem_elastoplasticity_tpu.models.config import FootingConfig as JaxFootingConfig
from fem_elastoplasticity_tpu.models.materials import elastic_tangent_lanes as jelastic_tangent
from fem_elastoplasticity_tpu.models.materials import lame_moduli
from fem_elastoplasticity_tpu.ops import assembly as jasm
from fem_elastoplasticity_tpu.ops.elements import ElementType as JaxElementType
from fem_elastoplasticity_tpu.ops.elements import volume_element as jvolume_element
from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes
from fem_elastoplasticity_tpu_torch.ops import assembly as pasm
from fem_elastoplasticity_tpu_torch.ops import return_map as rm
from fem_elastoplasticity_tpu_torch.ops.elements import volume_element

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
# pressure history of the unmodified reference run (P1, level 1), as
# tests/test_footing.py holds the JAX package to it
REFERENCE_PRESSURES = np.array([
    8.39724807, 13.20017031, 15.73188141, 16.14965303, 16.27589772,
    16.3163306, 16.38698285, 16.5422787, 16.62435145, 16.69057978,
    16.77442565, 16.83580515, 16.85149363, 16.84581189, 16.83867399,
    16.83636362,
])


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def f64_result():
    return footing.solve(FootingConfig(), device="cpu")


def test_mesh_equals_jax():
    jm = jfoot.build_mesh(JaxFootingConfig())
    pm = footing.build_mesh(FootingConfig())
    assert (pm.n_nodes, pm.n_elems, pm.n_free_dofs) == (441, 800, 816)
    for name in ("coords", "elems", "free", "dirichlet", "surface", "neumann"):
        np.testing.assert_array_equal(getattr(pm, name), getattr(jm, name), err_msg=name)
    assert pm.elems.dtype == jm.elems.dtype


def test_tangent_matvec_and_projection_equal_jax():
    mesh = footing.build_mesh(FootingConfig())
    rng = np.random.default_rng(7)
    jg = jasm.compute_geometry(
        jnp.asarray(mesh.coords), jnp.asarray(mesh.elems), jvolume_element(JaxElementType.P1)
    )
    pg = pasm.compute_geometry(torch.as_tensor(mesh.coords), mesh.elems, volume_element(mesh.etype))
    n_int = pg.n_int
    assert n_int == jg.n_int == 896
    a = rng.normal(size=(3, 3, n_int))
    d = a + a.transpose(1, 0, 2)
    v = rng.normal(size=2 * mesh.n_nodes)
    q = rng.normal(size=n_int)
    got = pasm.tangent_matvec(pg, torch.as_tensor(d), torch.as_tensor(v)).numpy()
    exp = np.asarray(jasm.tangent_matvec(jg, jnp.asarray(d), jnp.asarray(v)))
    assert rel(got, exp) < 1e-13
    got = pasm.project_to_nodes(pg, torch.as_tensor(q), pasm.node_gather_map(pg)).numpy()
    exp = np.asarray(jasm.project_to_nodes(jg, jnp.asarray(q)))
    assert got.shape == (mesh.n_nodes,)
    assert rel(got, exp) < 1e-13


def test_f64_anchors_and_jax_fixture(f64_result):
    r = f64_result
    assert r.n_steps == 16
    assert abs(r.zeta_hist[16] - 1.032) < 1e-12
    assert abs(r.zeta_hist[1] - 1e-3) < 1e-15
    assert rel(r.pressure_hist[1:17], REFERENCE_PRESSURES) < 1e-4
    exp = np.load(FIXTURES / "footing_f64.npz")
    counts = (r.n_steps, r.n_newton_total, r.n_plastic)
    assert counts == tuple(int(exp[k]) for k in ("n_steps", "n_newton_total", "n_plastic"))
    assert rel(r.u, exp["u"]) < 1e-11
    np.testing.assert_allclose(r.zeta_hist, exp["zeta_hist"], rtol=0, atol=1e-15)
    assert rel(r.pressure_hist, exp["pressure_hist"]) < 1e-11
    assert rel(r.ep, exp["ep"]) < 1e-9


def test_bug_compatible_apex_matches_reference_tightly():
    r = footing.solve(FootingConfig(bug_compatible_apex=True), device="cpu")
    assert rel(r.pressure_hist[1:17], REFERENCE_PRESSURES) < 1e-8


def test_fast_f32_limit_pressure(f64_result):
    """Pure-f32 path through K2's plain version on the CPU: the adaptive
    schedule differs from the f64 one (the doubling rule's `crit < tol` is
    a sharp branch at the f32 criterion floor); the limit pressure does
    not."""
    rm.LAUNCHES.clear()
    r = footing.solve(FootingConfig.fast_f32(), device="cpu")
    assert rm.LAUNCHES["dp_return_map_plain"] > 0 and rm.LAUNCHES["dp_return_map"] == 0
    exp = np.load(FIXTURES / "footing_f32.npz")
    print(
        f"footing f32: port {r.n_steps} steps / {r.n_newton_total} Newton its, "
        f"JAX {int(exp['n_steps'])} / {int(exp['n_newton_total'])}"
    )
    assert r.zeta_hist[r.n_steps] >= 1.0
    p32, p64 = r.pressure_hist[r.n_steps], f64_result.pressure_hist[16]
    assert abs(p32 - p64) / p64 < 5e-4
    pj = float(exp["pressure_hist"][int(exp["n_steps"])])
    assert abs(p32 - pj) / pj < 5e-4
    assert np.isfinite(r.u).all() and r.u.shape == (441, 2)


def _predictor_port(mesh, fmap, n_free, free, dtype):
    """The footing's elastic predictor as `footing.solve` forms it:
    (B, K_free, rhs on the free DOFs, u on the free DOFs)."""
    cfg = FootingConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    g = pasm.compute_geometry(torch.as_tensor(mesh.coords, dtype=dtype), mesh.elems,
                              volume_element(mesh.etype))
    ud = -cfg.d_zeta * torch.as_tensor(mesh.dirichlet.reshape(-1), dtype=dtype)
    D = elastic_tangent_lanes(shear, bulk, g.n_int, dtype, torch.device("cpu"))
    f = (-pasm.tangent_matvec(g, D, ud))[free]
    K = pasm.assemble_dense_free(pasm.element_stiffness(g, D), pasm.dense_free_plan(g, fmap, n_free))
    u = torch.cholesky_solve(f[:, None], torch.linalg.cholesky(K))[:, 0]
    return g.B.numpy(), K.numpy(), f.numpy(), u.numpy()


def _torch_cho_solve(K, f):
    K, f = torch.tensor(K), torch.tensor(f)
    return torch.cholesky_solve(f[:, None], torch.linalg.cholesky(K))[:, 0].numpy()


def test_f32_elastic_predictor_against_jax():
    """The f32 footing's first linear solve, port against the JAX package
    on the CPU.  Geometry and load vector agree bitwise, and so does the
    assembled K_free: the port adds each entry's element contributions in
    the order of the JAX package's scatter-add.  The two Cholesky routes
    still round differently, and cond(K_free) ~ 6e3 lifts that to a gap of
    some 1e-5 in the predictor: the gap from which the f32 schedules of the
    two packages part (run with -s for the split)."""
    cfg = JaxFootingConfig()
    mesh = footing.build_mesh(FootingConfig())
    fmap, n_free = pasm.free_dof_map(mesh.free)
    free = np.nonzero(mesh.free.reshape(-1))[0]
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)

    @jax.jit
    def jax_predictor(coords, dirichlet):
        g = jasm.compute_geometry(coords, jnp.asarray(mesh.elems), jvolume_element(JaxElementType.P1))
        D = jelastic_tangent(shear, bulk, g.n_int, jnp.float32)
        f = (-jasm.tangent_matvec(g, D, -cfg.d_zeta * dirichlet))[free]
        K = jasm.assemble_dense_free(jasm.element_stiffness(g, D), g, jnp.asarray(fmap), n_free)
        return g.B, K, f, jsl.cho_solve(jsl.cho_factor(K), f)

    jB, jK, jf, ju = (np.asarray(x) for x in jax_predictor(
        jnp.asarray(mesh.coords, jnp.float32), jnp.asarray(mesh.dirichlet.reshape(-1), jnp.float32)))
    pB, pK, pf, pu = _predictor_port(mesh, fmap, n_free, free, torch.float32)
    u64 = _predictor_port(mesh, fmap, n_free, free, torch.float64)[3]
    np.testing.assert_array_equal(pB, jB)
    np.testing.assert_array_equal(pf, jf)
    k_rel = rel(pK, jK)
    gap = rel(pu, ju)
    # the same K (JAX's) through the two Cholesky routes: the factorization's share
    factor_gap = rel(_torch_cho_solve(jK, jf), ju)
    # JAX's K against the port's, both through torch's Cholesky: the assembly's share
    assembly_gap = rel(_torch_cho_solve(jK, jf), pu)
    print(
        f"f32 predictor: K_free rel {k_rel:.3e}; u port vs JAX {gap:.3e} "
        f"(assembly order {assembly_gap:.3e}, factorization {factor_gap:.3e}); "
        f"vs f64: port {rel(pu, u64):.3e}, JAX {rel(ju, u64):.3e}"
    )
    np.testing.assert_array_equal(pK, jK)
    assert k_rel == 0.0 and assembly_gap == 0.0
    # what remains is the factorization: LAPACK's blocked Cholesky against
    # the JAX package's
    assert gap == factor_gap
    assert gap < 5e-5 and rel(pu, u64) < 2e-4 and rel(ju, u64) < 2e-4
