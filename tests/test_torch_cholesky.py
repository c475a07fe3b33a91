"""PyTorch port: the blocked Cholesky of kernel K7 on the CPU.

The plain version (`ops/cholesky.py`, the TPU kernel's algorithm step for
step in PyTorch) is held to the JAX package's Pallas kernel run in
interpret mode on the same seeded matrices, to LAPACK's f64 factor and
solve, and to the f64 solve of the tsx stiffness.  The CUDA kernel itself
is held to the plain version on the card (`tests/test_torch_gpu.py`,
`chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu.ops import cholesky_pallas as jchol
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes, lame_moduli
from fem_elastoplasticity_tpu_torch.ops import assembly as asm
from fem_elastoplasticity_tpu_torch.ops import cholesky as chol
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element

torch.set_num_threads(1)


def spd(n: int):
    """The seeded SPD matrix and right-hand side of `tests/test_cholesky_pallas.py`."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(n, n))
    A = (A @ A.T + n * np.eye(n)).astype(np.float32)
    return A, rng.normal(size=n).astype(np.float32)


def rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("n", [128, 200])
def test_plain_matches_jax_interpret_and_lapack(n):
    """L and inv_blocks within 1e-6, x within 1e-5 of the Pallas kernel in
    interpret mode (the sums of the block products run in another order);
    L and x within 5e-6 of LAPACK's f64 factor and solve, as the JAX
    package's own test holds its kernel."""
    A, b = spd(n)
    Lj, ij = jchol.cholesky_factor(jnp.asarray(A))
    xj = np.asarray(jchol.cholesky_solve(Lj, ij, jnp.asarray(b), n))
    L, inv = chol.cholesky_factor(torch.tensor(A))
    x = chol.cholesky_solve(L, inv, torch.tensor(b), n).numpy()
    L, inv = L.numpy(), inv.numpy()
    assert L.shape == np.shape(Lj) and inv.shape == np.shape(ij) and x.shape == (n,)
    # the Pallas kernel leaves the strict upper part of L unwritten
    assert rel(L, np.tril(np.asarray(Lj))) < 1e-6
    assert rel(inv, np.asarray(ij)) < 1e-6
    assert rel(x, xj) < 1e-5
    ref = np.linalg.solve(A.astype(np.float64), b.astype(np.float64))
    assert rel(x, ref) < 5e-6
    assert rel(L[:n, :n], np.linalg.cholesky(A.astype(np.float64))) < 5e-6


def test_padding_layout():
    """n = 200 pads to 256: L lower with a zero strict upper part and the
    identity tail, inv_blocks the inverses of L's diagonal blocks."""
    n = 200
    A, _ = spd(n)
    L, inv = (t.double().numpy() for t in chol.cholesky_factor(torch.tensor(A)))
    assert L.shape == (256, 256) and inv.shape == (256, 128)
    assert (np.triu(L, 1) == 0).all()
    np.testing.assert_array_equal(L[n:, n:], np.eye(256 - n))
    assert (L[n:, :n] == 0).all()
    for k in range(2):
        blk = L[128 * k:128 * (k + 1), 128 * k:128 * (k + 1)]
        assert np.abs(inv[128 * k:128 * (k + 1)] @ blk - np.eye(128)).max() < 1e-5


def test_plain_on_the_tsx_stiffness():
    """The Jacobi-scaled f32 elastic K_free of the tsx mesh (908 unknowns),
    assembled by the port: the solve within 1e-4 of the f64 solve (cond
    ~1e3 in f32), as `tests/test_cholesky_pallas.py:63-65` requires."""
    mesh = tsx.tsx_mesh(ElementType.P1)
    geom = asm.compute_geometry(torch.as_tensor(mesh.coords), mesh.elems,
                                volume_element(ElementType.P1))
    shear, bulk = lame_moduli(60000.0, 0.2)
    D = elastic_tangent_lanes(shear, bulk, geom.n_int, torch.float64, torch.device("cpu"))
    fmap, n_free = asm.free_dof_map(mesh.free)
    K = asm.assemble_dense_free(asm.element_stiffness(geom, D),
                                asm.dense_free_plan(geom, fmap, n_free))
    d = torch.rsqrt(torch.diagonal(K))
    Ks = (K * d[:, None] * d[None, :]).to(torch.float32)
    assert n_free == 908
    chol.LAUNCHES.clear()
    L, inv = chol.cholesky_factor(Ks)
    x = chol.cholesky_solve(L, inv, torch.ones(n_free), n_free).numpy()
    assert chol.LAUNCHES == {"cholesky_factor_plain": 1, "cholesky_solve_plain": 1}
    ref = np.linalg.solve(Ks.double().numpy(), np.ones(n_free))
    assert rel(x, ref) < 1e-4


def test_kernel_wrappers_refuse_host_tensors():
    """The CUDA wrappers launch or raise: a host tensor is refused before
    anything is built."""
    A, b = spd(128)
    with pytest.raises(ValueError, match="CUDA"):
        chol.cholesky_factor_cuda(torch.tensor(A))
    L, inv = chol.cholesky_factor_plain(torch.tensor(A))
    with pytest.raises(ValueError, match="CUDA"):
        chol.cholesky_solve_cuda(L, inv, torch.tensor(b), 128)
    with pytest.raises(ValueError, match="square"):
        chol.cholesky_factor(torch.zeros(3, 4))
