"""PyTorch port: the 2x2 node-block layout of the smoother (K4, K5), on the CPU.

`ops.spmv.node_blocks` turns a level's f32 CSR into the layout the sweep
kernels read; `node_block_sweep_plain` is their plain version, summing
each row in ascending block order, product by product, as the kernels do.
Here the layout is held to the CSR it came from, the builder's refusals
are shown, the plain sweep is held bit for bit to an ordered sum on the
CSR and, within the tolerance of `test_torch_spmv.py`, to the JAX
package's `slot_sweep_b` in interpret mode (`test_torch_spmv.py` and
`test_torch_packed.py` hold it to `slot_sweep`, `slot_sweep_pk` and
`slot_matvec_pk`).  The kernels themselves run on the card
(`test_torch_gpu.py`, `chip_smoke.py`).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fem_elastoplasticity_tpu.ops import spmv as jspmv
from fem_elastoplasticity_tpu_torch.models.materials import lame_moduli
from fem_elastoplasticity_tpu_torch.models.tsx_tunnel import _DATA, _free_of
from fem_elastoplasticity_tpu_torch.ops import elements as pel
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.solve import multigrid as pmg

torch.set_num_threads(1)


def blocked_spd(n_n: int, seed: int, partial: float = 0.0):
    """A seeded random symmetric operator with 2x2 nodal blocks, a heavy
    diagonal and about 12 blocks a node.  With `partial`, that share of the
    off-diagonal blocks loses one of its four entries (each row of the
    block keeps one, so the pattern stays blocked)."""
    rng = np.random.default_rng(seed)
    N = sp.random(n_n, n_n, density=6.0 / n_n, random_state=seed)
    nodes = ((N + N.T + sp.eye(n_n)) != 0).astype(np.float64)
    A = sp.kron(nodes, np.ones((2, 2)), format="csr")
    A.data = rng.standard_normal(A.nnz)
    K = (A + A.T + 10 * sp.eye(2 * n_n)).tocsr()
    if partial:
        coo = K.tocoo()
        r, c = coo.row, coo.col
        # one entry of a chosen block: the block's (even row, odd column)
        drop = ((r // 2) != (c // 2)) & (r % 2 == 0) & (c % 2 == 1)
        drop &= rng.random(drop.shape[0]) < partial
        K = sp.csr_matrix((coo.data[~drop], (r[~drop], c[~drop])), shape=K.shape)
    K.sort_indices()
    return K


def _blocked_problem(seed: int, partial: float = 0.0):
    """A BC-masked blocked operator (`blocked_spd`) with its free mask and a
    damped block inverse (that of `tests/test_spmv.py`'s fused-sweep
    test)."""
    rng = np.random.default_rng(seed)
    free = rng.random(600) > 0.15
    Kb = jspmv.apply_bc_csr(blocked_spd(300, seed, partial), free)
    blocks = jspmv.diag_blocks_csr(Kb, 300)
    a_, b_, c_, d_ = blocks[:, 0, 0], blocks[:, 0, 1], blocks[:, 1, 0], blocks[:, 1, 1]
    inv = (np.stack([np.stack([d_, -b_], -1), np.stack([-c_, a_], -1)], -2)
           / (a_ * d_ - b_ * c_)[:, None, None]) * 0.7
    return rng, Kb, free, inv


def as_scipy(B: pspmv.NodeBlockMatrix):
    """The layout as a scipy BSR matrix with 2x2 blocks: the same arrays."""
    return sp.bsr_matrix(
        (B.block_values.to(torch.float32).numpy().reshape(-1, 2, 2), B.block_cols.numpy(),
         B.node_ptr.numpy()), shape=B.shape)


_LEVELS = {}


def scale_levels(levels: int):
    """The `fast_scale(levels)` hierarchy on the CPU and the f32 CSR
    operators of its levels (from the host hierarchy: the device one keeps
    the fine level's CSR only)."""
    if levels not in _LEVELS:
        with np.load(_DATA) as raw:
            coords, elems = raw["coords"].astype(np.float64), raw["elems"]
        shear, bulk = lame_moduli(60000.0, 0.2)
        hier, _, coarse = pmg.build_hierarchy_ell(
            coords, elems, levels, _free_of, shear, bulk,
            pel.volume_element(pel.ElementType.P1), device="cpu")
        ops = [pspmv.csr_to_device(h["K"], "cpu", np.float32) for h in coarse["levels"]]
        _LEVELS[levels] = hier, ops
    return _LEVELS[levels]


@pytest.mark.parametrize("case", ["fast_scale1", "fast_scale2", "random"])
def test_layout_round_trips_to_the_csr(case):
    """The node blocks hold the CSR's matrix exactly: the same dense matrix
    on every level of the hierarchies, and on a random blocked operator
    with partly present blocks, whose missing entries are explicit zeros."""
    if case == "random":
        K = blocked_spd(200, 4, partial=0.3)
        ops = [pspmv.csr_to_device(K, "cpu", np.float32)]
    else:
        ops = scale_levels(int(case[-1]))[1]
    for A in ops:
        B = pspmv.node_blocks(A)
        dense = torch.sparse_csr_tensor(A.indptr, A.indices, A.values, A.shape).to_dense()
        np.testing.assert_array_equal(as_scipy(B).toarray(), dense.numpy())
        # neighbours ascend within a node, and every entry is in a block
        cols = B.block_cols.long()
        node = torch.repeat_interleave(torch.arange(B.n_nodes), B.blocks_per_node().long())
        assert bool((cols[1:] > cols[:-1])[node[1:] == node[:-1]].all())
        assert int((B.block_values != 0).sum()) == int((A.values != 0).sum())
        assert B.width == int(B.blocks_per_node().max())
        if case == "random":  # partly present blocks were filled with zeros
            assert 4 * B.block_cols.shape[0] > A.values.shape[0]
        hist = torch.bincount(B.blocks_per_node().long())
        if case != "random":  # P1: an interior node has 7 blocks
            assert int(hist.argmax()) == 7


def _unsorted(A):
    idx = A.indices.clone()
    lo, hi = int(A.indptr[5]), int(A.indptr[6])
    idx[lo:hi] = idx[lo:hi].flip(0)
    return A._replace(indices=idx)


def _rows_differ(K):
    """K with one entry more in row 2, in a node column row 3 lacks."""
    m = int(np.setdiff1d(np.arange(K.shape[0] // 2), K[2].indices // 2)[0])
    K = K.tolil()
    K[2, 2 * m] = 1.0
    return K.tocsr()


@pytest.mark.parametrize("fault", ["odd_size", "unsorted", "rows_differ"])
def test_builder_raises_on_a_non_blocked_operator(fault):
    K = blocked_spd(40, 1)
    A = pspmv.csr_to_device(K, "cpu", np.float32)
    bad = {
        "odd_size": lambda: pspmv.csr_to_device(K[:79, :79], "cpu", np.float32),
        "unsorted": lambda: _unsorted(A),
        "rows_differ": lambda: pspmv.csr_to_device(_rows_differ(K), "cpu", np.float32),
    }[fault]()
    pspmv.node_blocks(A)  # the operator itself is fine
    with pytest.raises(ValueError, match="node_blocks"):
        pspmv.node_blocks(bad)


def ordered_csr_sweep(A: pspmv.CsrMatrix, aux, z, r, update):
    """The sweep with each CSR row summed in index order, one product at a
    time (rows padded to the longest with zero products)."""
    counts = (A.indptr[1:] - A.indptr[:-1]).long()
    n, width = A.shape[0], int(counts.max())
    row = torch.repeat_interleave(torch.arange(n), counts)
    slot = torch.arange(A.values.shape[0]) - A.indptr.long()[row]
    vals = torch.zeros(n, width)
    cols = torch.zeros(n, width, dtype=torch.long)
    vals[row, slot] = A.values.to(torch.float32)
    cols[row, slot] = A.indices.long()
    acc = torch.zeros(n)
    for j in range(width):
        acc = torch.add(acc, torch.mul(vals[:, j], z[cols[:, j]]))
    res = (r - acc) * aux.mask
    if not update:
        return res
    return z + (aux.msf * res + aux.mpr * res.reshape(-1, 2).flip(1).reshape(-1)) * aux.mask


@pytest.mark.parametrize("update", [True, False], ids=["update", "residual"])
def test_block_plain_sweep_keeps_the_csr_order(update):
    """On the same seeded inputs, the plain sweep on the node blocks equals
    an ordered sum on the CSR bit for bit: the layout keeps each row's
    order of summation.  On a random operator with partly present blocks
    and on the fine level of `fast_scale(2)`, f32 and bf16 values."""
    _, Kb, free, inv = _blocked_problem(9)
    Kp = blocked_spd(300, 9, partial=0.3)
    cases = [(pspmv.csr_to_device(Kb, "cpu", np.float32), pspmv.sweep_aux(inv, free, "cpu")),
             (pspmv.csr_to_device(Kp, "cpu", np.float32), pspmv.sweep_aux(inv, free, "cpu"))]
    hier, ops = scale_levels(2)
    cases.append((ops[-1], hier.levels[-1].aux))
    rng = np.random.default_rng(7)
    for A, aux in cases:
        n = A.shape[0]
        z = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
        r = torch.as_tensor(rng.standard_normal(n).astype(np.float32))
        for dtype in (torch.float32, torch.bfloat16):
            B = pspmv.node_blocks(A, dtype)
            widened = A._replace(values=A.values.to(dtype).to(torch.float32))
            got = pspmv.node_block_sweep_plain(B, aux, z, r, update)
            assert torch.equal(got, ordered_csr_sweep(widened, aux, z, r, update))


@pytest.mark.parametrize("partial", [0.0, 0.3], ids=["whole_blocks", "partly_filled"])
@pytest.mark.parametrize("update", [True, False], ids=["update", "residual"])
def test_block_plain_sweep_matches_jax_slot_sweep_b(update, partial):
    """The plain sweep on f32 node blocks against the JAX package's
    `slot_sweep_b` (the sweep on a padded iterate) on the same operator,
    iterate and right-hand side: within 5e-6 of max |y| (the kernel sums a
    row in slot order, the port in column order), constrained rows exact;
    on whole blocks and on partly present ones."""
    rng, Kb, free, inv = _blocked_problem(3, partial)
    n = Kb.shape[0]
    z = rng.standard_normal(n).astype(np.float32)
    r = np.where(free, rng.standard_normal(n), 0.0).astype(np.float32)
    arrays, meta = jspmv.build_slot(Kb)
    out = jspmv.slot_sweep_b(arrays, meta, jspmv.build_sweep_aux(inv, free, meta),
                             jspmv.pad_rhs(jnp.asarray(z), meta),
                             jspmv.pad_rhs(jnp.asarray(r), meta), update=update)
    exp = np.asarray(out).reshape(-1)[:n]
    B = pspmv.node_blocks(pspmv.csr_to_device(Kb, "cpu", np.float32))
    pspmv.LAUNCHES.clear()
    got = pspmv.block_jacobi_sweep(B, pspmv.sweep_aux(inv, free, "cpu"),
                                   torch.as_tensor(z), torch.as_tensor(r), update)
    assert pspmv.LAUNCHES == {"block_jacobi_sweep_plain": 1}
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=5e-6 * np.abs(exp).max())
    np.testing.assert_array_equal(got.numpy()[~free], z[~free] if update else 0.0)


def test_bf16_blocks_carry_the_jax_packages_bits():
    """The bf16 blocks are, bit for bit, the JAX package's `_bf16_bits` of
    the f32 values (f64 -> f32 -> bf16, nearest even), at the same places."""
    Kb = _blocked_problem(5)[1]
    A = pspmv.csr_to_device(Kb, "cpu", np.float32)
    B32, B16 = pspmv.node_blocks(A), pspmv.node_blocks(A, torch.bfloat16)
    assert torch.equal(B16.node_ptr, B32.node_ptr) and torch.equal(B16.block_cols, B32.block_cols)
    want = jspmv._bf16_bits(B32.block_values.numpy()).astype(np.uint16)
    got = B16.block_values.view(torch.int16).numpy().view(np.uint16)
    np.testing.assert_array_equal(got, want)
    rounded = torch.as_tensor(as_scipy(B32).toarray()).to(torch.bfloat16).to(torch.float32)
    np.testing.assert_array_equal(as_scipy(B16).toarray(), rounded.numpy())
