"""PyTorch port: projected preconditioned CG against the JAX package's.

Both `solve_cg` run on the same operator, right-hand side and block-Jacobi
preconditioner: the BC-masked elastic stiffness of the once-refined tsx
mesh (3,678 DOFs), applied as a scipy/torch sparse product on both sides,
so that only the CG recurrences are compared.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import sparse as jsparse

from fem_elastoplasticity_tpu.models.materials import lame_moduli
from fem_elastoplasticity_tpu.models.tsx_tunnel import tsx_mesh
from fem_elastoplasticity_tpu.ops import spmv as jspmv
from fem_elastoplasticity_tpu.ops.elements import ElementType, volume_element
from fem_elastoplasticity_tpu.solve import cg as jcg
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.solve import cg as pcg

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def system():
    mesh = tsx_mesh(ElementType.P1, 1)
    shear, bulk = lame_moduli(60000.0, 0.2)
    _, _, K = jspmv.build_ell_elastic(
        mesh.coords, mesh.elems, volume_element(ElementType.P1), shear, bulk,
        free=mesh.free, fmt="slot")
    free = np.asarray(mesh.free).reshape(-1)
    blocks = jspmv.diag_blocks_csr(K, mesh.n_nodes)
    b = np.random.default_rng(11).standard_normal(K.shape[0]) * free
    return dict(K=K, free=free, blocks=blocks, b=b)


def _both(system, dtype, **kw):
    """(JAX result, port result) of the same solve in `dtype`."""
    K, free, blocks, b = system["K"], system["free"], system["blocks"], system["b"]
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    Kj = jsparse.BCSR.from_scipy_sparse(K.astype(np_dt))
    rj = jcg.solve_cg(
        lambda v: Kj @ v, jnp.asarray(b, np_dt), jnp.asarray(free),
        precond=jcg.block_jacobi_preconditioner(jnp.asarray(blocks, np_dt), jnp.asarray(free)),
        **kw)
    Kt = pspmv.csr_to_device(K, "cpu", np_dt)
    free_t = torch.as_tensor(free)
    rp = pcg.solve_cg(
        lambda v: pspmv.csr_matvec_plain(Kt, v), torch.as_tensor(b.astype(np_dt)), free_t,
        precond=pcg.block_jacobi_preconditioner(torch.as_tensor(blocks.astype(np_dt)), free_t),
        **kw)
    return rj, rp


def test_f64_same_iterations_and_solution(system):
    rj, rp = _both(system, torch.float64, tol=1e-10, maxiter=2000)
    assert rp.converged and bool(rj.converged)
    assert rp.iters == int(rj.iters) > 50
    x = np.asarray(rj.x)
    assert np.abs(rp.x.numpy() - x).max() <= 1e-10 * np.abs(x).max()
    # after some hundred iterations the two residuals share their leading digits
    assert abs(float(rp.rel_residual) - float(rj.rel_residual)) <= 1e-2 * float(rj.rel_residual)
    assert (rp.x.numpy()[~system["free"]] == 0).all()
    # the solution solves the system on the free DOFs
    res = (system["K"] @ rp.x.numpy() - system["b"]) * system["free"]
    assert np.abs(res).max() <= 1e-7 * np.abs(system["b"]).max()


def test_f32_iterations_within_one(system):
    rj, rp = _both(system, torch.float32, tol=1e-5, maxiter=2000)
    assert rp.converged and bool(rj.converged)
    assert abs(rp.iters - int(rj.iters)) <= 1
    x = np.asarray(rj.x)
    assert rp.x.dtype == torch.float32
    assert np.abs(rp.x.numpy() - x).max() <= 1e-5 * np.abs(x).max()


def test_cap_reports_not_converged(system):
    rj, rp = _both(system, torch.float64, tol=1e-10, maxiter=3)
    assert rp.iters == int(rj.iters) == 3
    assert rp.converged is False and not bool(rj.converged)
    assert 0.0 < float(rp.rel_residual) <= 1.0 + 1e-12
    np.testing.assert_allclose(float(rp.rel_residual), float(rj.rel_residual), rtol=1e-9)


def test_breakdown_guard_stops_on_an_indefinite_operator():
    n = 40
    d = np.ones(n)
    d[n // 2:] = -1.0  # p.Ap < 0 at the first step for this right-hand side
    b = np.zeros(n)
    b[n // 2:] = 1.0
    free = np.ones(n, bool)
    rj = jcg.solve_cg(lambda v: jnp.asarray(d) * v, jnp.asarray(b), jnp.asarray(free),
                      tol=1e-10, maxiter=50)
    rp = pcg.solve_cg(lambda v: torch.as_tensor(d) * v, torch.as_tensor(b), torch.as_tensor(free),
                      tol=1e-10, maxiter=50)
    assert rp.iters == int(rj.iters) == 1
    assert rp.converged is False and not bool(rj.converged)
    assert float(rp.x.abs().max()) == 0.0  # the best iterate is kept: alpha = 0


def test_zero_right_hand_side_and_tensor_tolerance(system):
    Kt = pspmv.csr_to_device(system["K"], "cpu", np.float32)
    free_t = torch.as_tensor(system["free"])
    mv = lambda v: pspmv.csr_matvec_plain(Kt, v)  # noqa: E731
    r0 = pcg.solve_cg(mv, torch.zeros(Kt.shape[0]), free_t, tol=1e-5)
    assert r0.iters == 0 and r0.converged and float(r0.x.abs().max()) == 0.0
    b = torch.as_tensor(system["b"].astype(np.float32))
    a = pcg.solve_cg(mv, b, free_t, tol=1e-3, maxiter=500)
    t = pcg.solve_cg(mv, b, free_t, tol=torch.tensor(1e-3), maxiter=500)
    assert a.iters == t.iters and torch.equal(a.x, t.x)
    # a warm start at the solution stops at once
    w = pcg.solve_cg(mv, b, free_t, x0=a.x, tol=1e-2, maxiter=500)
    assert w.iters == 0 and w.converged


@pytest.mark.parametrize("kw,exc", [
    # deflation is ported (tests/test_torch_deflation.py); as in the JAX
    # package it refuses a start vector
    (dict(deflate=torch.zeros(4, 2), x0=torch.ones(4)), ValueError),
    # "scan" is ported (tests/test_torch_tsx_options.py); a structure the
    # JAX package does not have raises, as there
    (dict(structure="unrolled"), ValueError),
], ids=["deflate", "scan"])
def test_unported_options_raise(kw, exc):
    with pytest.raises(exc):
        pcg.solve_cg(lambda v: v, torch.ones(4), torch.ones(4, dtype=torch.bool), **kw)
