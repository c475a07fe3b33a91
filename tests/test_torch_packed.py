"""PyTorch port: the bf16-valued smoother (K5) and the packed hierarchy (CPU).

K5 itself (CUDA) runs only on the card (`test_torch_gpu.py`,
`chip_smoke.py`).  Here its plain version and the packed multigrid path are
held against the JAX package's packed-stream kernels (`slot_sweep_pk`,
`slot_matvec_pk`), run in interpret mode as `tests/test_spmv.py` runs them,
and the packed scale slice against the JAX fixture `tsx_scale_l1_packed.npz`
(`tools/make_port_fixtures.py`).  Both packages round the f32 operator
values to bf16 the same way and compute in f32; the row sums add in other
orders, so the comparisons hold f32 rounding tolerances.
"""
import functools
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fem_elastoplasticity_tpu.models.materials import lame_moduli
from fem_elastoplasticity_tpu.models.tsx_tunnel import _DATA
from fem_elastoplasticity_tpu.ops import spmv as jspmv
from fem_elastoplasticity_tpu.ops.elements import ElementType, volume_element
from fem_elastoplasticity_tpu.solve import cg as jcg
from fem_elastoplasticity_tpu.solve import multigrid as jmg
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.models.tsx_tunnel import _free_of
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.solve import cg as pcg
from fem_elastoplasticity_tpu_torch.solve import multigrid as pmg
from fem_elastoplasticity_tpu_torch.utils.convert import hierarchy_from_numpy

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"


@pytest.fixture(scope="module")
def jax_l1_packed():
    """The JAX package's level-1 slot hierarchy with every level packed, and
    the same host data as the port's packed hierarchy."""
    with np.load(_DATA) as raw:
        coords, elems = raw["coords"].astype(np.float64), raw["elems"]
    shear, bulk = lame_moduli(60000.0, 0.2)
    jarr, jmeta, _, jcoarse = jmg.build_hierarchy_ell(
        coords, elems, 1, _free_of, shear, bulk, volume_element(ElementType.P1),
        fmt="slot", pack_bf16=True, collect_levels=True)
    host = [dict(lv, inv=np.asarray(a["inv"])) for lv, a in zip(jcoarse["levels"], jarr)]
    hier = hierarchy_from_numpy(host, jcoarse["inv0"], jcoarse["free_idx0"], device="cpu",
                                pack_bf16=True)
    return jarr, jmeta, jcoarse, hier


def test_bf16_values_are_the_jax_packages_bits(jax_l1_packed):
    """The port's bf16 node blocks hold, bit for bit, the JAX package's
    `_bf16_bits` of the f32 values (f64 -> f32 -> bf16, nearest even), at
    the places of the f32 operator's entries, on every level of the level-1
    hierarchy; the FEM operators' blocks are whole, so no other value."""
    jarr, jmeta, jcoarse, hier = jax_l1_packed
    for lev, host in zip(hier.levels, jcoarse["levels"]):
        B = lev.sweep_op
        assert B is not None and B.block_values.dtype == torch.bfloat16
        K = host["K"].tocsr()
        K.sort_indices()
        assert 4 * B.block_cols.shape[0] == K.nnz
        rows = np.repeat(np.arange(K.shape[0]), np.diff(K.indptr))
        # the block of each entry: node rows // 2, neighbour K.indices // 2;
        # blocks ascend by (node, neighbour)
        n_n = B.n_nodes
        node = np.repeat(np.arange(n_n), B.blocks_per_node().numpy())
        blk = np.searchsorted(node * n_n + B.block_cols.numpy(),
                              rows // 2 * n_n + K.indices // 2)
        got = B.block_values.view(torch.int16).numpy().view(np.uint16)
        want = jspmv._bf16_bits(K.data.astype(np.float32)).astype(np.uint16)
        np.testing.assert_array_equal(got[blk, 2 * (rows % 2) + K.indices % 2], want)


def _drop_block_entries(K, share: float, seed: int):
    """K without a seeded share of its off-diagonal blocks' (even row, odd
    column) entries: blocks partly present, the pattern still 2x2-blocked."""
    coo = K.tocoo()
    r, c = coo.row, coo.col
    drop = ((r // 2) != (c // 2)) & (r % 2 == 0) & (c % 2 == 1)
    drop &= np.random.default_rng(seed).random(coo.nnz) < share
    out = sp.csr_matrix((coo.data[~drop], (r[~drop], c[~drop])), shape=K.shape)
    out.sort_indices()
    return out


def _random_spd(partial: float = 0.0):
    """A small random SPD operator with constrained rows, of the size of
    `tests/test_spmv.py::test_packed_slot_matches_bf16_rounded`'s, with
    2x2 nodal blocks (every operator the sweep reads has them); with
    `partial`, that share of its off-diagonal blocks lacks an entry."""
    rng = np.random.default_rng(11)
    n_n = 350
    n = 2 * n_n
    N = sp.random(n_n, n_n, density=0.02, random_state=5)
    A = sp.kron(((N + N.T + sp.eye(n_n)) != 0).astype(np.float64), np.ones((2, 2)), format="csr")
    A.data = np.random.default_rng(5).random(A.nnz)
    K = (A + A.T + 10 * sp.eye(n)).tocsr()
    if partial:
        K = _drop_block_entries(K, partial, 5)
    free = rng.random(n) > 0.15
    Kb = jspmv.apply_bc_csr(K.copy(), free)
    inv = rng.standard_normal((n_n, 2, 2)).astype(np.float32)
    return rng, Kb, free, inv


# on whole 2x2 blocks and on partly present ones (stored as zeros)
SWEEP_OPERATORS = [pytest.param(True, 0.0, id="update"), pytest.param(False, 0.0, id="residual"),
                   pytest.param(True, 0.3, id="update-partly_filled"),
                   pytest.param(False, 0.3, id="residual-partly_filled")]


@pytest.mark.parametrize("update,partial", SWEEP_OPERATORS)
def test_plain_packed_sweep_matches_jax_slot_sweep_pk(update, partial):
    """`slot_sweep_pk` on `pack_slot_bf16` against the port's sweep on the
    bf16-valued operator: the same f32 arithmetic on the same bf16 values,
    rows summed in another order, within 1e-6 of max |y|."""
    rng, Kb, free, inv = _random_spd(partial)
    n = Kb.shape[0]
    arrays, meta = jspmv.build_slot(Kb)
    pk = jspmv.pack_slot_bf16(arrays, meta)
    aux_j = jspmv.build_sweep_aux(inv, free, meta)
    z = rng.standard_normal(n).astype(np.float32)
    r = rng.standard_normal(n).astype(np.float32)
    exp = np.asarray(jspmv.slot_sweep_pk(
        pk, meta, aux_j, jnp.asarray(z), jspmv.pad_rhs(jnp.asarray(r), meta), update))

    A = pspmv.node_blocks(pspmv.csr_to_device(Kb, "cpu", np.float32), torch.bfloat16)
    aux = pspmv.sweep_aux(inv, free, "cpu")
    pspmv.LAUNCHES.clear()
    got = pspmv.block_jacobi_sweep(A, aux, torch.as_tensor(z), torch.as_tensor(r), update)
    assert pspmv.LAUNCHES == {"block_jacobi_sweep_bf16_plain": 1}
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=1e-6 * np.abs(exp).max())
    np.testing.assert_array_equal(got.numpy()[~free], z[~free] if update else 0.0)


def test_packed_matvec_matches_jax_slot_matvec_pk():
    """`slot_matvec_pk` and the port's `packed_matvec` (K5's masked residual
    with r = 0, mask = 1, negated): within 1e-6 of max |y|."""
    _packed_matvec_against_jax(0.0)


def test_packed_matvec_matches_jax_slot_matvec_pk_on_partly_filled_blocks():
    """As above, on an operator of which 30% of the off-diagonal blocks lack
    an entry (stored as zeros in the node blocks)."""
    _packed_matvec_against_jax(0.3)


def _packed_matvec_against_jax(partial: float):
    rng, Kb, _, _ = _random_spd(partial)
    arrays, meta = jspmv.build_slot(Kb)
    pk = jspmv.pack_slot_bf16(arrays, meta)
    v = rng.standard_normal(Kb.shape[0]).astype(np.float32)
    exp = np.asarray(jspmv.slot_matvec_pk(pk, meta, jnp.asarray(v)))
    A = pspmv.node_blocks(pspmv.csr_to_device(Kb, "cpu", np.float32), torch.bfloat16)
    pspmv.LAUNCHES.clear()
    got = pspmv.packed_matvec(A, torch.as_tensor(v)).numpy()
    assert pspmv.LAUNCHES == {"block_jacobi_sweep_bf16_plain": 1}
    np.testing.assert_allclose(got, exp, rtol=0, atol=1e-6 * np.abs(exp).max())


def _jax_vcycle(jarr, jmeta, jcoarse):
    idx0 = jcoarse["free_idx0"]

    def coarse_solve(r):
        return jnp.zeros_like(r).at[idx0].set(jcoarse["inv0"] @ r[idx0])

    vc = jmg.make_vcycle_ell(jmeta, coarse_solve, nu=2)
    return jax.jit(lambda r: vc(jarr, r))


def test_packed_vcycle_matches_jax(jax_l1_packed):
    """One V-cycle of the packed level-1 hierarchy in both packages, on the
    same operators: within 1e-5 of max |z|; every smoother call is K5's."""
    jarr, jmeta, jcoarse, hier = jax_l1_packed
    assert all("opk" in a for a in jarr[1:])
    n = hier.levels[-1].op.shape[0]
    r = np.random.default_rng(2).standard_normal(n).astype(np.float32)
    exp = np.asarray(_jax_vcycle(jarr, jmeta, jcoarse)(jnp.asarray(r)))
    pspmv.LAUNCHES.clear()
    got = pmg.make_vcycle_ell(hier, nu=2)(torch.as_tensor(r)).numpy()
    assert pspmv.LAUNCHES == {"block_jacobi_sweep_bf16_plain": 4, "node_transfer_plain": 2}
    assert np.abs(got - exp).max() <= 1e-5 * np.abs(exp).max()
    assert (got[~hier.levels[-1].free.numpy()] == 0).all()


def test_packed_vcycle_preconditioned_cg_matches_jax(jax_l1_packed):
    """PCG with the packed V-cycle on the level-1 elastic system, as
    `tests/test_spmv.py::test_packed_hierarchy_vcycle_preconditions_cg`:
    both converge, the iteration counts within 1, the solutions within
    1e-4 of max |x|.  CG's operator keeps the f32 values."""
    jarr, jmeta, jcoarse, hier = jax_l1_packed
    fine = hier.levels[-1]
    free = fine.free.numpy()
    b = np.random.default_rng(0).standard_normal(free.shape[0]).astype(np.float32)
    rj = jcg.solve_cg(
        lambda v: jspmv.sp_matvec(jarr[-1]["op"], jmeta[-1]["op"], v), jnp.asarray(b),
        jnp.asarray(free), precond=_jax_vcycle(jarr, jmeta, jcoarse), tol=1e-6, maxiter=100)
    rp = pcg.solve_cg(
        lambda v: pspmv.sp_matvec(fine.op, v), torch.as_tensor(b), fine.free,
        precond=pmg.make_vcycle_ell(hier, nu=2), tol=1e-6, maxiter=100)
    assert rp.converged and bool(rj.converged)
    print(f"packed PCG: port {rp.iters} iterations, JAX {int(rj.iters)}")
    assert abs(rp.iters - int(rj.iters)) <= 1
    x = np.asarray(rj.x)
    assert np.abs(rp.x.numpy() - x).max() <= 1e-4 * np.abs(x).max()


def test_packed_scale_slice_against_jax(monkeypatch):
    """`fast_scale(1)` with every level packed on both sides (the fixture
    writer forces it the same way): the JAX package's steps, Newton
    iterations and plastic points, u within 1e-8; the CG total printed."""
    monkeypatch.setattr(pmg, "build_hierarchy_ell",
                        functools.partial(pmg.build_hierarchy_ell, pack_bf16=True))
    pspmv.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast_scale(1), device="cpu")
    launches = dict(pspmv.LAUNCHES)
    exp = np.load(FIXTURES / "tsx_scale_l1_packed.npz")
    print(f"packed L1: port {r.n_steps} / {r.n_newton_total} / {r.n_cg_total} CG / "
          f"{r.n_plastic}, JAX {int(exp['n_steps'])} / {int(exp['n_newton_total'])} / "
          f"{int(exp['n_cg_total'])} CG / {int(exp['n_plastic'])}")
    assert (r.n_steps, r.n_newton_total, r.n_plastic) == (
        int(exp["n_steps"]), int(exp["n_newton_total"]), int(exp["n_plastic"]))
    assert np.abs(r.u - exp["u"]).max() <= 1e-8 * np.abs(exp["u"]).max()
    # every sweep of the cycle went through K5's plain version, none through K4's
    assert launches["block_jacobi_sweep_bf16_plain"] > 0
    assert "block_jacobi_sweep_plain" not in launches
