"""PyTorch port: the assembled operators and the module of kernels K1, K3, K4.

K1 itself (CUDA) runs only on the card: `test_torch_gpu.py` and
`chip_smoke.py` hold it against its plain version there.  Here the port's
CSR operators are held against the scipy CSR that the JAX package builds
inside `build_residual_slot_df`, and the plain version against the JAX
package's double-float slot kernel `slot_matvec_df`, run in interpret mode
on the CPU as `tests/test_spmv.py` runs it.  K3's and K4's plain versions
are held the same way against `slot_matvec` and `slot_sweep`.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import scipy.sparse as sp

from fem_elastoplasticity_tpu.models.tsx_tunnel import tsx_mesh
from fem_elastoplasticity_tpu.ops import assembly_df as jadf
from fem_elastoplasticity_tpu.ops import spmv as jspmv
from fem_elastoplasticity_tpu.ops.elements import ElementType, volume_element
from fem_elastoplasticity_tpu_torch.ops import assembly as pasm
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.ops import elements as pel
from fem_elastoplasticity_tpu_torch.utils.convert import geometry_from_df

# tiny tensors: extra threads only contend with the other test workers
torch.set_num_threads(1)


@pytest.fixture(scope="module")
def operators():
    """(JAX slot operators, JAX's scipy G/S, the port's scipy and device G/S)."""
    mesh = tsx_mesh()
    gdf = jadf.geometry_df(mesh.coords, mesh.elems, volume_element(ElementType.P1))
    captured = []
    real = jspmv.build_slot_df

    def spy(A, **kw):
        captured.append(A.copy())
        return real(A, **kw)

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jspmv, "build_slot_df", spy)
        Ga, Gm, Sa, Sm = jspmv.build_residual_slot_df(gdf, fmt="rslot")
    G_jax, S_jax = captured

    # build_residual_csr on the same f64 geometry, carried across
    g = geometry_from_df(
        gdf.hi.B, gdf.B_lo, gdf.hi.weight, gdf.w_lo, gdf.hi.edofs,
        gdf.hi.n_nodes, gdf.hi.n_q, gdf.hi.n_real,
    )
    G, S = pspmv.build_residual_csr(
        g.B.numpy(), g.weight.numpy(), g.edofs.numpy(), g.n_q, g.n_nodes
    )
    # and from the port's own geometry
    pg = pasm.compute_geometry(
        torch.as_tensor(mesh.coords), mesh.elems, pel.volume_element(pel.ElementType.P1)
    )
    Gp, Sp = pspmv.build_residual_csr(
        pg.B.numpy(), pg.weight.numpy(), pg.edofs.numpy(), pg.n_q, pg.n_nodes
    )
    return dict(
        jax=(Ga, Gm, Sa, Sm), G_jax=G_jax, S_jax=S_jax, G=G, S=S, G_port=Gp, S_port=Sp,
        Gt=pspmv.csr_to_device(Gp, "cpu"), St=pspmv.csr_to_device(Sp, "cpu"),
    )


@pytest.mark.parametrize("name", ["G", "S"])
def test_csr_equals_jax(operators, name):
    theirs = operators[name + "_jax"]
    theirs.sort_indices()
    # same geometry in: same matrix out, pattern and values
    mine = operators[name]
    assert mine.shape == theirs.shape
    np.testing.assert_array_equal(mine.indptr, theirs.indptr)
    np.testing.assert_array_equal(mine.indices, theirs.indices)
    np.testing.assert_allclose(mine.data, theirs.data, rtol=1e-15, atol=0)
    # the port's own f64 geometry rounds a few ulp away from XLA's
    # (test_torch_assembly.py holds it at 1e-12): same pattern, values
    # within 1e-14 relative
    own = operators[name + "_port"]
    np.testing.assert_array_equal(own.indptr, theirs.indptr)
    np.testing.assert_array_equal(own.indices, theirs.indices)
    np.testing.assert_allclose(own.data, theirs.data, rtol=1e-14, atol=0)
    # padding integration points have no entries
    n_int = 896
    rows = np.diff(operators["G"].indptr).reshape(3, n_int)
    assert (rows[:, 887:] == 0).all() and (rows[:, :887] > 0).all()


def _split(x64):
    hi = x64.astype(np.float32)
    return hi, (x64 - hi.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("name", ["G", "S"])
def test_plain_matches_jax_slot_matvec_df(operators, name):
    Ga, Gm, Sa, Sm = operators["jax"]
    arrays, meta = (Ga, Gm) if name == "G" else (Sa, Sm)
    A = operators[name + "t"]
    rng = np.random.default_rng(5)
    x = rng.standard_normal(A.shape[1])
    if name == "G":
        x *= 1e-3  # displacement-sized
    else:
        x[np.tile(np.arange(896) >= 887, 3)] = 0.0  # padding stresses
    hi, lo = _split(x)
    oh, ol = jax.jit(lambda a, h, l: jspmv.slot_matvec_df(a, meta, h, l))(arrays, hi, lo)
    exp = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    got = pspmv.csr_matvec(A, torch.as_tensor(hi.astype(np.float64) + lo.astype(np.float64)))
    rel = np.linalg.norm(got.numpy() - exp) / np.linalg.norm(exp)
    assert rel <= 1e-13, rel


def test_dispatch_routes_by_device(operators):
    A = operators["Gt"]
    x = torch.as_tensor(np.random.default_rng(6).standard_normal(A.shape[1]))
    pspmv.LAUNCHES.clear()
    y = pspmv.csr_matvec(A, x)
    assert pspmv.LAUNCHES == {"csr_spmv_f64_plain": 1}
    np.testing.assert_array_equal(y.numpy(), pspmv.csr_matvec_plain(A, x).numpy())
    np.testing.assert_allclose(y.numpy(), operators["G"] @ x.numpy(), rtol=0, atol=1e-13)


def test_kernel_wrapper_refuses_cpu_tensors(operators):
    """Asked for the kernel with a CPU tensor, the wrapper raises: it never
    falls back to the plain version, and launches nothing."""
    A = operators["St"]
    pspmv.LAUNCHES.clear()
    with pytest.raises(ValueError, match="CUDA"):
        pspmv.csr_spmv_f64_cuda(A, torch.zeros(A.shape[1], dtype=torch.float64))
    assert pspmv.LAUNCHES["csr_spmv_f64"] == 0

    with pytest.raises(ValueError, match="CUDA"):
        pspmv.csr_spmv_f32_cuda(A, torch.zeros(A.shape[1], dtype=torch.float32))
    with pytest.raises(ValueError, match="CUDA"):
        pspmv.block_jacobi_sweep_cuda(
            pspmv.node_blocks(pspmv.csr_to_device(sp.eye(4, format="csr"), "cpu", np.float32)),
            None, torch.zeros(4), torch.zeros(4))
    assert not pspmv.LAUNCHES["csr_spmv_f32"] and not pspmv.LAUNCHES["block_jacobi_sweep"]


# ---------------------------------------------------------------------------
# the CSR kernel's row blocks (K1, K3's CSR kernel): the host table, and a
# NumPy model of the kernel's two phases that pins each row's sum order
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def row_block_cases():
    """{name: f64 CsrMatrix on the CPU}: the port's G and S of the tsx mesh
    at P1 and P4, and a synthetic matrix with empty rows (first, inside,
    last) and one row of 5 E entries."""
    from fem_elastoplasticity_tpu_torch.models.tsx_tunnel import tsx_mesh as ptsx_mesh

    cases = {}
    for et in ("P1", "P4"):
        mesh = ptsx_mesh(pel.ElementType[et])
        geom = pasm.compute_geometry(torch.as_tensor(mesh.coords), mesh.elems,
                                     pel.volume_element(pel.ElementType[et]))
        cases[f"G_{et}"], cases[f"S_{et}"] = pspmv.residual_operators(geom, "cpu")
    rng = np.random.default_rng(17)
    n_cols = 8000
    deg = np.concatenate([[0, 2, 0, 0, 5 * pspmv.ROW_BLOCK_ENTRIES, 9, 0],
                          rng.integers(0, 30, 1500), [0, 0, 0]])
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = np.concatenate([np.sort(rng.choice(n_cols, d, replace=False)) for d in deg])
    M = sp.csr_matrix((rng.standard_normal(indptr[-1]), indices, indptr),
                      shape=(deg.shape[0], n_cols))
    cases["synthetic"] = pspmv.csr_to_device(M, "cpu")
    return cases


def two_phase_f32(A, x: np.ndarray) -> np.ndarray:
    """NumPy model of the CSR kernel's f32 instance (`ops/csrc/csr_spmv.cu`)
    on A's row blocks: each block's entries in chunks of E; phase 1 stages
    the chunk's products v x, rounded to f32; phase 2 adds, for every row of
    the block at once, that row's next staged product to the row's own f32
    accumulator, in CSR order, carried across chunks."""
    indptr, idx, vals = A.indptr.numpy(), A.indices.numpy(), A.values.numpy()
    y = np.zeros(A.n_rows, np.float32)
    cap = pspmv.ROW_BLOCK_ENTRIES
    for (r0, k0), (r1, k1) in zip(A.row_blocks.numpy()[:-1], A.row_blocks.numpy()[1:]):
        acc = np.zeros(r1 - r0, np.float32)
        kb, ke = indptr[r0:r1], indptr[r0 + 1:r1 + 1]
        for c0 in range(k0, k1, cap):
            c1 = min(c0 + cap, k1)
            stage = vals[c0:c1] * x[idx[c0:c1]]
            a, b = np.maximum(kb, c0), np.minimum(ke, c1)
            for j in range(int((b - a).max(initial=0))):
                live = a + j < b
                acc[live] += stage[a[live] + j - c0]
        y[r0:r1] = acc
    return y


@pytest.mark.parametrize("name", ["G_P1", "S_P1", "G_P4", "S_P4", "synthetic"])
def test_row_blocks_cut_every_row_once(row_block_cases, name):
    """Every row lies in exactly one block, the blocks in row order, each
    block with at most T rows and at most E entries unless it is a single
    longer row; the entry offsets are the rows' CSR offsets, and a new value
    array on the same structure keeps the table."""
    A = row_block_cases[name]
    rb = A.row_blocks.numpy()
    indptr = A.indptr.numpy()
    assert A.row_blocks.dtype == torch.int32 and rb.ndim == 2 and rb.shape[1] == 2
    rows, first = rb[:, 0], rb[:, 1]
    assert rows[0] == 0 and rows[-1] == A.n_rows and (np.diff(rows) > 0).all()
    np.testing.assert_array_equal(first, indptr[rows])
    n_rows, n_entries = np.diff(rows), np.diff(first)
    assert (n_rows <= pspmv.ROW_BLOCK_ROWS).all()
    assert ((n_entries <= pspmv.ROW_BLOCK_ENTRIES) | (n_rows == 1)).all()
    if name == "synthetic":
        assert (n_entries > pspmv.ROW_BLOCK_ENTRIES).sum() == 1
    A32 = A._replace(values=A.values.to(torch.float32))
    assert A32.row_blocks is A.row_blocks


@pytest.mark.parametrize("name", ["G_P1", "S_P1", "G_P4", "S_P4", "synthetic"])
def test_two_phase_model_is_the_plain_f32_sum(row_block_cases, name):
    """The two phases on the row blocks give the plain version's f32 y bit
    for bit (`index_add_` on the CPU adds each row's products in CSR
    order): the sum order that the CSR kernel keeps."""
    A = row_block_cases[name]
    A32 = A._replace(values=A.values.to(torch.float32))
    x = np.random.default_rng(19).standard_normal(A.shape[1]).astype(np.float32)
    want = pspmv.csr_matvec_plain(A32, torch.as_tensor(x)).numpy()
    np.testing.assert_array_equal(two_phase_f32(A32, x), want)
    np.testing.assert_array_equal(
        pspmv.csr_matvec_row_serial(A32, torch.as_tensor(x)).numpy(), want)


# ---------------------------------------------------------------------------
# K3 (f32 CSR SpMV) and K4 (fused block-Jacobi sweep): plain versions
# against the JAX package's slot kernels in interpret mode
# ---------------------------------------------------------------------------
def _elastic_k_l1():
    """The JAX package's BC-masked elastic CSR on the RCM-ordered tsx mesh."""
    from fem_elastoplasticity_tpu.models.materials import lame_moduli

    mesh = tsx_mesh()
    order = jspmv.rcm_node_order(mesh.elems, mesh.n_nodes)
    c2, e2, _ = jspmv.permute_mesh(mesh.coords, mesh.elems, order)
    free2 = np.asarray(mesh.free)[order]
    shear, bulk = lame_moduli(60000.0, 0.2)
    _, _, K = jspmv.build_ell_elastic(
        c2, e2, volume_element(ElementType.P1), shear, bulk, free=free2, fmt="slot")
    return K, free2.reshape(-1)


def _k3_cases():
    K, _ = _elastic_k_l1()
    cases = {"elastic": K}
    for shape in [(700, 350), (130, 900), (128, 128)]:
        M = sp.random(*shape, density=0.02, random_state=11, format="csr")
        M.sum_duplicates()
        cases["x".join(map(str, shape))] = M
    return cases


@pytest.mark.parametrize("case", ["elastic", "700x350", "130x900", "128x128"])
def test_k3_plain_matches_jax_slot_matvec(case):
    """The same scipy CSR through `build_slot` + `slot_matvec` and through
    the port's f32 `csr_matvec`: the slot kernel adds a row's entries in
    slot order, the CSR version in column order, so they agree to f32
    rounding of the row sum, 2e-6 of max |y|."""
    M = _k3_cases()[case]
    arrays, meta = jspmv.build_slot(M)
    rng = np.random.default_rng(5)
    v = rng.standard_normal(M.shape[1]).astype(np.float32)
    exp = np.asarray(jax.jit(lambda a, vv: jspmv.slot_matvec(a, meta, vv))(arrays, jnp.asarray(v)))
    A = pspmv.csr_to_device(M, "cpu", np.float32)
    assert A.values.dtype == torch.float32
    pspmv.LAUNCHES.clear()
    got = pspmv.csr_matvec(A, torch.as_tensor(v))
    assert pspmv.LAUNCHES == {"csr_spmv_f32_plain": 1}
    assert got.dtype == torch.float32 and got.shape == (M.shape[0],)
    scale = max(np.abs(exp).max(), 1e-30)
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(got.numpy(), M @ v.astype(np.float64), rtol=0, atol=2e-6 * scale)


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


# on whole 2x2 blocks and on partly present ones (stored as zeros)
SWEEP_OPERATORS = [pytest.param(True, 0.0, id="update"), pytest.param(False, 0.0, id="residual"),
                   pytest.param(True, 0.3, id="update-partly_filled"),
                   pytest.param(False, 0.3, id="residual-partly_filled")]


@pytest.mark.parametrize("update,partial", SWEEP_OPERATORS)
def test_k4_plain_matches_jax_slot_sweep(update, partial):
    """`slot_sweep` with `build_sweep_aux` against `block_jacobi_sweep` on
    one operator (2x2-blocked, as every operator the sweep reads; with
    `partial`, that share of blocks lacks an entry), iterate and right-hand
    side: within 5e-6."""
    rng = np.random.default_rng(3)
    n_n = 300
    n = 2 * n_n
    N = sp.random(n_n, n_n, density=0.02, random_state=7)
    A = sp.kron(((N + N.T + sp.eye(n_n)) != 0).astype(np.float64), np.ones((2, 2)), format="csr")
    A.data = np.random.default_rng(7).random(A.nnz)
    K = (A + A.T + 10 * sp.eye(n)).tocsr()
    if partial:
        K = _drop_block_entries(K, partial, 7)
    free = rng.random(n) > 0.15
    Kb = jspmv.apply_bc_csr(K.copy(), free)
    arrays, meta = jspmv.build_slot(Kb)
    blocks = jspmv.diag_blocks_csr(Kb, n_n)
    a_, b_, c_, d_ = blocks[:, 0, 0], blocks[:, 0, 1], blocks[:, 1, 0], blocks[:, 1, 1]
    inv = (
        np.stack([np.stack([d_, -b_], -1), np.stack([-c_, a_], -1)], -2)
        / (a_ * d_ - b_ * c_)[:, None, None]
    ) * 0.7
    z = rng.standard_normal(n).astype(np.float32)
    r = np.where(free, rng.standard_normal(n), 0.0).astype(np.float32)
    aux_j = jspmv.build_sweep_aux(inv, free, meta)
    exp = np.asarray(jspmv.slot_sweep(
        arrays, meta, aux_j, jnp.asarray(z), jspmv.pad_rhs(jnp.asarray(r), meta), update=update))

    At = pspmv.csr_to_device(Kb, "cpu", np.float32)
    aux = pspmv.sweep_aux(inv, free, "cpu")
    for name in ("mask", "msf", "mpr"):  # the same constants, without the tile padding
        np.testing.assert_array_equal(
            getattr(aux, name).numpy(), np.asarray(aux_j[name]).reshape(-1)[:n])
    pspmv.LAUNCHES.clear()
    B = pspmv.node_blocks(At)
    got = pspmv.block_jacobi_sweep(B, aux, torch.as_tensor(z), torch.as_tensor(r), update=update)
    assert pspmv.LAUNCHES == {"block_jacobi_sweep_plain": 1}
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=5e-6 * np.abs(exp).max())
    fixed = ~free
    np.testing.assert_array_equal(got.numpy()[fixed], z[fixed] if update else 0.0)
