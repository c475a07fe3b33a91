"""PyTorch port: K3 on node layouts, on the CPU.

K3 (the JAX package's `slot_matvec`) runs in the port as two kernels: the
product y = A x on the f32 2x2 node blocks the smoother reads (the sweep
kernel's product epilogue, `ops.spmv.node_block_matvec`), for CG's
operator, the Newton criterion and the predictor; and the multigrid
transfers as `ops.spmv.NodeTransfer`s, with the V-cycle's mask, or mask
and add, fused in (`ops.spmv.transfer`).  Their plain versions are held
here to `slot_matvec` in interpret mode (as `test_torch_spmv.py` holds the
CSR product), and bit for bit to what the V-cycle and the solves computed
before on the CSR: the CSR row sums in index order, then `torch.where` and
`torch.add`.  The tangent refresh through the table mapped onto the block
values is held bit for bit to the refresh of the CSR values.  The kernels
themselves run on the card (`test_torch_gpu.py`, `chip_smoke.py`).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fem_elastoplasticity_tpu.ops import spmv as jspmv
from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes, lame_moduli
from fem_elastoplasticity_tpu_torch.models.tsx_tunnel import _DATA, _free_of
from fem_elastoplasticity_tpu_torch.ops import assembly as pasm
from fem_elastoplasticity_tpu_torch.ops import elements as pel
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.solve import multigrid as pmg
from fem_elastoplasticity_tpu_torch.solve.newton import refreshed_values

torch.set_num_threads(1)

_LEVELS = {}


def scale_hierarchy(levels: int):
    """(device hierarchy on the CPU, host levels) of `fast_scale(levels)`."""
    if levels not in _LEVELS:
        with np.load(_DATA) as raw:
            coords, elems = raw["coords"].astype(np.float64), raw["elems"]
        shear, bulk = lame_moduli(60000.0, 0.2)
        hier, _, coarse = pmg.build_hierarchy_ell(
            coords, elems, levels, _free_of, shear, bulk,
            pel.volume_element(pel.ElementType.P1), device="cpu")
        _LEVELS[levels] = hier, coarse["levels"]
    return _LEVELS[levels]


def _jax_slot_matvec(M, v: np.ndarray) -> np.ndarray:
    arrays, meta = jspmv.build_slot(sp.csr_matrix(M))
    return np.asarray(jax.jit(lambda a, vv: jspmv.slot_matvec(a, meta, vv))(arrays, jnp.asarray(v)))


# ---------------------------------------------------------------------------
# the product on f32 node blocks
# ---------------------------------------------------------------------------
def test_node_block_product_matches_jax_slot_matvec():
    """The fine elastic operator of `fast_scale(1)` through `build_slot` +
    `slot_matvec` and through the port's node-block product: the slot
    kernel adds a row in slot order, the port in column order, so they
    agree to f32 rounding of the row sum, 2e-6 of max |y| (K3's
    tolerance, `test_torch_spmv.py`)."""
    hier, host = scale_hierarchy(1)
    B, K = hier.levels[-1].op, host[-1]["K"]
    v = np.random.default_rng(11).standard_normal(K.shape[1]).astype(np.float32)
    exp = _jax_slot_matvec(K, v)
    pspmv.LAUNCHES.clear()
    got = pspmv.sp_matvec(B, torch.as_tensor(v))
    assert pspmv.LAUNCHES == {"node_block_spmv_plain": 1}
    assert got.dtype == torch.float32 and got.shape == (K.shape[0],)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=2e-6 * np.abs(exp).max())


@pytest.mark.parametrize("levels", [1, 2])
def test_node_block_product_is_the_csr_sum_and_the_negated_residual(levels):
    """On the fine operator of `fast_scale(1)` and `(2)`: the plain product
    equals the CSR row sums in index order (the plain CSR product, which
    sums in order on the CPU) and the negated masked residual of the plain
    sweep with mask 1 and r = 0, bit for bit."""
    hier, host = scale_hierarchy(levels)
    B = hier.levels[-1].op
    A = pspmv.csr_to_device(host[-1]["K"], "cpu", np.float32)
    x = torch.as_tensor(np.random.default_rng(levels).standard_normal(A.shape[0]),
                        dtype=torch.float32)
    y = pspmv.node_block_matvec(B, x)
    assert torch.equal(y, pspmv.csr_matvec_plain(A, x))
    zeros = torch.zeros_like(x)
    aux = pspmv.SweepAux(mask=torch.ones_like(x), msf=zeros, mpr=zeros)
    assert torch.equal(y, -pspmv.node_block_sweep_plain(B, aux, x, zeros, update=False))


def test_node_block_product_refusals():
    """Only f32 node blocks have a product kernel; the kernel wrapper takes
    only a CUDA tensor and launches nothing here."""
    hier, _ = scale_hierarchy(1)
    B = hier.levels[-1].op
    x = torch.zeros(B.shape[0])
    pspmv.LAUNCHES.clear()
    with pytest.raises(ValueError, match="bfloat16"):
        pspmv.node_block_matvec(B._replace(block_values=B.block_values.to(torch.bfloat16)), x)
    with pytest.raises(ValueError, match="CUDA"):
        pspmv.node_block_spmv_cuda(B, x)
    with pytest.raises(ValueError, match="CUDA"):
        pspmv.node_transfer_cuda(hier.levels[-1].R, x)
    assert not pspmv.LAUNCHES


# ---------------------------------------------------------------------------
# the tangent refresh through the block positions
# ---------------------------------------------------------------------------
def _refresh_both(K, table, corr, rows):
    """(refreshed block values through the mapped table, `node_blocks` of
    the CSR refreshed through the CSR table): rows of the tables are the
    elements each correction block belongs to."""
    A = pspmv.csr_to_device(K, "cpu", np.float32)
    B = pspmv.node_blocks(A)
    dest_csr = torch.as_tensor(table)[rows]
    dest_blk = pspmv.node_block_dest(table, K, "cpu")[rows]
    n_csr, n_blk = A.values.numel(), B.block_values.numel()
    # the stepper's -1 -> past-the-end rule
    vals_csr = refreshed_values(A.values, corr, torch.where(dest_csr >= 0, dest_csr, n_csr).long())
    vals_blk = refreshed_values(B.block_values.reshape(-1), corr,
                                torch.where(dest_blk >= 0, dest_blk, n_blk).long())
    return vals_blk.reshape(-1, 4), pspmv.node_blocks(A._replace(values=vals_csr)).block_values


def test_refresh_of_a_plastic_slot_set_equals_the_refreshed_csr_in_blocks():
    """tsx `fast_scale(1)`'s fine level: the plastic correction blocks of a
    seeded slot set (a run of neighbouring elements, which share entries,
    and scattered ones, with invalid slots), scattered into the node-block
    values through `node_block_dest`'s table, are `node_blocks` of the CSR
    refreshed through `element_corr_dest`'s table, bit for bit."""
    _, host = scale_hierarchy(1)
    top = host[-1]
    table = pspmv.element_corr_dest(top["K"], top["elems"], top["free"])
    geom = pasm.compute_geometry(torch.as_tensor(top["coords"]), top["elems"],
                                 pel.volume_element(pel.ElementType.P1)).to(torch.float32)
    shear, bulk = lame_moduli(60000.0, 0.2)
    d_el = elastic_tangent_lanes(shear, bulk, geom.n_int, torch.float32, torch.device("cpu"))
    rng = np.random.default_rng(8)
    ind_p = np.zeros(geom.n_int, bool)
    ind_p[300:364] = True
    ind_p[rng.choice(geom.n_real * geom.n_q, 40, replace=False)] = True
    d = d_el * torch.as_tensor(1.0 - 0.3 * rng.random(geom.n_int), dtype=torch.float32)
    idx_p, valid_p = pasm.plastic_slots(torch.as_tensor(ind_p), 128)
    assert int(valid_p.sum()) < 128  # invalid slots carry zero blocks
    Bp, wdelta, _ = pasm.plastic_correction_gather(geom, d - d_el, idx_p, valid_p)
    corr = torch.einsum("aip,abp,bjp->pij", Bp, wdelta, Bp)
    got, want = _refresh_both(top["K"], table, corr, idx_p // geom.n_q)
    assert torch.equal(got, want)
    assert not torch.equal(got, pspmv.node_blocks(
        pspmv.csr_to_device(top["K"], "cpu", np.float32)).block_values)


def test_full_element_refresh_of_the_footing_equals_the_refreshed_csr_in_blocks():
    """The footing's assembled operator at level 1 (`assembled_cg=True`):
    every element's tangent deviation, scattered into the node-block values
    through the mapped table, is `node_blocks` of the CSR refreshed through
    the CSR table, bit for bit; and the setup's operator and table are
    exactly that pair."""
    cfg = FootingConfig.fast(solver="cg", assembled_cg=True)
    mesh2, op, table_blk, _, _ = footing._assembled_setup(cfg, footing.build_mesh(cfg), "cpu")
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    K = pspmv.build_elastic_csr(mesh2.coords, mesh2.elems, pel.volume_element(cfg.etype),
                                shear, bulk, free=mesh2.free)
    table = pspmv.element_corr_dest(K, mesh2.elems, mesh2.free)
    assert torch.equal(table_blk, pspmv.node_block_dest(table, K, "cpu"))
    assert torch.equal(op.block_values,
                       pspmv.node_blocks(pspmv.csr_to_device(K, "cpu", np.float32)).block_values)
    geom = pasm.compute_geometry(torch.as_tensor(mesh2.coords), mesh2.elems,
                                 pel.volume_element(cfg.etype)).to(torch.float32)
    d_el = elastic_tangent_lanes(shear, bulk, geom.n_int, torch.float32, torch.device("cpu"))
    rng = np.random.default_rng(9)
    d = d_el * torch.as_tensor(1.0 - 0.5 * rng.random(geom.n_int), dtype=torch.float32)
    corr = pasm.element_stiffness(geom, d - d_el).permute(2, 0, 1)[:table.shape[0]]
    got, want = _refresh_both(K, table, corr, torch.arange(table.shape[0]))
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the transfers
# ---------------------------------------------------------------------------
def _transfer_case(which: str):
    """(NodeTransfer, host f64 CSR, output level's free mask) of level 2 of
    `fast_scale(2)`: P (output level 2) or R = P^T (output level 1)."""
    hier, host = scale_hierarchy(2)
    lev = hier.levels[2]
    P = sp.csr_matrix(host[2]["P"])
    if which == "P":
        return lev.P, P, lev.free
    R = P.T.tocsr()
    R.sum_duplicates()
    return lev.R, R, hier.levels[1].free


MODES = ["plain", "masked", "masked_add"]


def _mode_args(mode, mask, n, rng):
    if mode == "plain":
        return None, None
    z = torch.as_tensor(rng.standard_normal(n), dtype=torch.float32) if mode == "masked_add" else None
    return mask, z


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("which", ["P", "R"])
def test_transfer_matches_jax_slot_matvec(which, mode):
    """P and R of `fast_scale(2)` through `build_slot` + `slot_matvec` (the
    masks and the add applied in numpy) and through the node transfer in
    each of its modes: within 2e-6 of max |y|."""
    T, M, free = _transfer_case(which)
    rng = np.random.default_rng(len(which) + MODES.index(mode))
    v = rng.standard_normal(M.shape[1]).astype(np.float32)
    mask, z = _mode_args(mode, free, M.shape[0], rng)
    exp = _jax_slot_matvec(M, v)
    if mask is not None:
        exp = np.where(mask.numpy(), exp, np.float32(0))
    if z is not None:
        exp = z.numpy() + exp
    pspmv.LAUNCHES.clear()
    got = pspmv.transfer(T, torch.as_tensor(v), mask, z)
    assert pspmv.LAUNCHES == {"node_transfer_plain": 1}
    assert got.dtype == torch.float32 and got.shape == (M.shape[0],)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=2e-6 * np.abs(exp).max())


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("which", ["P", "R"])
def test_transfer_is_the_csr_product_then_where_and_add(which, mode):
    """Each mode equals what the V-cycle computed on the CSR before: the
    CSR row sums in index order, then `torch.where(free, y, 0)` and
    `z + ...`, bit for bit."""
    T, M, free = _transfer_case(which)
    rng = np.random.default_rng(7 + MODES.index(mode))
    x = torch.as_tensor(rng.standard_normal(M.shape[1]), dtype=torch.float32)
    mask, z = _mode_args(mode, free, M.shape[0], rng)
    want = pspmv.csr_matvec_plain(pspmv.csr_to_device(M, "cpu", np.float32), x)
    if mask is not None:
        want = torch.where(mask, want, torch.zeros((), dtype=torch.float32))
    if z is not None:
        want = z + want
    assert torch.equal(pspmv.transfer(T, x, mask, z), want)


def test_node_transfer_refuses_an_operator_that_is_not_node_level():
    """The builder raises where rows 2i and 2i+1 part in their weights or
    node columns, where a row takes the other component, or on an odd
    size; `transfer` adds z only under a mask."""
    _, P, _ = _transfer_case("P")
    pspmv.node_transfer(P, "cpu")
    odd_weight = P.copy()
    odd_weight.data[odd_weight.indptr[3]] *= 0.75  # row 3: the partner of row 2
    cross = P.tolil()
    cross[2, 1] = 0.25  # row 2 (component 0) reads component 1
    for bad in (odd_weight, cross.tocsr(), P[:-1]):
        with pytest.raises(ValueError):
            pspmv.node_transfer(bad, "cpu")
    T, M, free = _transfer_case("R")
    with pytest.raises(ValueError, match="mask"):
        pspmv.transfer(T, torch.zeros(M.shape[1]), z=torch.zeros(M.shape[0]))
