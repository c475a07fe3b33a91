"""PyTorch port: the recycled-Krylov deflation of the CG tangent solves (CPU).

`solve.cg.solve_cg(deflate=...)` (A-DEF2) and `deflation_harvest` against
the JAX package's on the same seeded inputs: an SPD model problem with an
isolated small-eigenvalue cluster (tests/test_cg_deflation.py), a ring
grown by harvests from capped and converged deflated solves.  Both run in
f32 with other summation orders, so iteration counts may differ by one and
x by f32 rounding (1e-5); the ring's slot index is equal and its unit
columns equal to 5e-5 (a capped solve's final residual, the difference of
far larger vectors, carries the f32 rounding of both runs).  An all-zero basis is plain PCG bit for bit.  The
checkpoint file of the JAX package (`solve/chunked.py`) loads with its
deflation keys and round-trips.
"""
import pathlib

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu.solve import cg as jcg
from fem_elastoplasticity_tpu_torch.solve.cg import deflation_harvest, solve_cg
from fem_elastoplasticity_tpu_torch.utils import convert

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"


def _cluster_problem(n=200, k_small=5, lam_small=1e-2, seed=0):
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    lam = np.concatenate([np.full(k_small, lam_small), 1.0 + rng.random(n - k_small)])
    A = (Q * lam) @ Q.T
    return 0.5 * (A + A.T), rng


def _grow_ring(A, rhs, k, free, tol, maxiters):
    """Solve each rhs deflated against the ring (capped at its entry of
    `maxiters`), harvesting x and (for unconverged solves) z after each, in
    both packages.  Returns the per-solve (iterations, x) of both and both
    final rings."""
    At = torch.as_tensor(A, dtype=torch.float32)
    Aj = jnp.asarray(A, jnp.float32)
    ft, fj = torch.as_tensor(free), jnp.asarray(free)
    Wt, ring_t = torch.zeros((A.shape[0], k)), 0
    Wj, ring_j = jnp.zeros((A.shape[0], k), jnp.float32), jnp.asarray(0, jnp.int32)
    out = []
    for b, cap in zip(rhs, maxiters):
        rt = solve_cg(lambda v: At @ v, torch.as_tensor(b), ft, tol=tol, maxiter=cap, deflate=Wt)
        rj = jcg.solve_cg(lambda v: Aj @ v, jnp.asarray(b), fj, tol=tol, maxiter=cap, deflate=Wj)
        out.append(((rt.iters, rt.x.numpy()), (int(rj.iters), np.asarray(rj.x))))
        Wt, ring_t = deflation_harvest(Wt, ring_t, [rt.x, rt.z], gates=[None, not rt.converged])
        Wj, ring_j = jcg.deflation_harvest(Wj, ring_j, [rj.x, rj.z], gates=[None, ~rj.converged])
    return out, (Wt.numpy(), ring_t), (np.asarray(Wj), int(ring_j))


def test_deflated_solves_and_ring_equal_jax():
    A, rng = _cluster_problem()
    free = np.ones(A.shape[0], bool)
    free[:3] = False  # constrained DOFs stay out of the basis and the solution
    rhs = [rng.standard_normal(A.shape[0]).astype(np.float32) for _ in range(6)]
    # three capped solves (x and z harvested: the 8-slot ring wraps), then
    # three that converge (x alone)
    solves, (Wt, ring_t), (Wj, ring_j) = _grow_ring(A, rhs, 8, free, 1e-5, (12,) * 3 + (60,) * 3)
    for (it_t, x_t), (it_j, x_j) in solves:
        assert abs(it_t - it_j) <= 1
        assert np.abs(x_t - x_j).max() <= 1e-5 * np.abs(x_j).max()
        assert (x_t[~free] == 0).all()
    assert ring_t == ring_j == 9 % 8
    # the basis cut the converged solves' iterations
    assert solves[-1][0][0] < 20
    np.testing.assert_allclose(Wt, Wj, rtol=0, atol=5e-5)
    np.testing.assert_allclose(Wt.T @ Wt, np.eye(Wt.shape[1]), atol=1e-5)


def test_zero_basis_is_plain_pcg_bit_for_bit():
    A, rng = _cluster_problem()
    At = torch.as_tensor(A, dtype=torch.float32)
    b = torch.as_tensor(rng.standard_normal(A.shape[0]), dtype=torch.float32)
    free = torch.ones(A.shape[0], dtype=torch.bool)
    pre = lambda r: r / torch.diagonal(At)  # noqa: E731
    plain = solve_cg(lambda v: At @ v, b, free, precond=pre, tol=1e-6, maxiter=500)
    zero = solve_cg(lambda v: At @ v, b, free, precond=pre, tol=1e-6, maxiter=500,
                    deflate=torch.zeros((A.shape[0], 8)))
    assert zero.iters == plain.iters and zero.converged == plain.converged
    assert torch.equal(zero.x, plain.x) and torch.equal(zero.z, plain.z)
    assert torch.equal(zero.rel_residual, plain.rel_residual)


def test_harvest_skips_gated_and_dependent_candidates():
    W = torch.zeros((6, 2))
    v = torch.tensor([1.0, 2.0, 0.0, 0.0, 0.0, 0.0])
    W, ring = deflation_harvest(W, 0, [v, 3.0 * v], gates=[None, None])
    assert ring == 1  # the second is v again: nothing of it survives
    W2, ring2 = deflation_harvest(W, ring, [torch.ones(6)], gates=[False])
    assert ring2 == ring and torch.equal(W2, W)
    W3, ring3 = deflation_harvest(W, ring, [torch.full((6,), float("nan"))])
    assert ring3 == ring and torch.equal(W3, W)


def test_solve_cg_refuses_deflation_with_a_start():
    b = torch.ones(4)
    with pytest.raises(ValueError):
        solve_cg(lambda v: v, b, torch.ones(4, dtype=torch.bool), x0=b,
                 deflate=torch.zeros((4, 2)))


def test_jax_checkpoint_loads_with_every_key(tmp_path):
    """The JAX package's carry after two load trips of fast_scale(2)
    (fixture footing_scale_l2_ckpt2.npz, `save_checkpoint` format) loads
    with the deflation basis as f32 and its ring as an int, and writing it
    back gives the JAX file's values."""
    path = FIXTURES / "footing_scale_l2_ckpt2.npz"
    carry = convert.load_checkpoint(path)
    with np.load(path) as raw:
        files = set(raw.files)
        assert {k[:-4] if k.endswith("__hi") else k for k in files
                if not k.endswith("__lo")} == set(carry)
        assert carry["defl_w"].dtype == torch.float32 and carry["defl_w"].shape == (3362, 16)
        assert np.array_equal(carry["defl_w"].numpy(), raw["defl_w"])
        assert isinstance(carry["defl_ring"], int) and carry["defl_ring"] == int(raw["defl_ring"])
        convert.save_checkpoint(tmp_path / "c.npz", carry)
        with np.load(tmp_path / "c.npz") as back:
            # the JAX file's keys and dtypes, and beside them the exact f64
            # copies, which the JAX package's loader skips (`__lo` keys
            # without a `__hi`)
            exact = {k for k in back.files if k.endswith(convert.EXACT_SUFFIX)}
            assert set(back.files) - exact == files and exact
            assert {k[: -len(convert.EXACT_SUFFIX)] for k in exact} <= set(carry)
            for k in files:
                assert back[k].dtype == raw[k].dtype, k
        again = convert.load_checkpoint(tmp_path / "c.npz")
    for k, v in carry.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(again[k], v), k
        else:
            assert again[k] == v, k
