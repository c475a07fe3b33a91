"""PyTorch port: the ELL operator format (K6), the gather correction and
the ELL scale slice (CPU).

K6 itself (CUDA) runs only on the card (`test_torch_gpu.py`,
`chip_smoke.py`).  Here the port's ELL build takes the JAX package's
row-degree cap, its plain products are held against the JAX package's
windowed-ELL kernels (`ell_matvec`, f32, and `ell_matvec_df` /
`sp_matvec_df`, double-float) run in interpret mode as `tests/test_spmv.py`
runs them, `plastic_correction_apply` against the JAX package's, and
`fast_scale(1, spmv_fmt="ell", corr_mode="gather", residual_fmt="ell")`
against the JAX fixture `tsx_scale_l1_ell.npz`, and the other pairings
of the three format options (and the dense bench preset with the ELL
residual) against theirs.  The port stores the operators as sliced ELL
(32 rows a slice, each slice as wide as its longest row up to the JAX
package's degree cap, the entries past the cap as a tail that the same
thread walks), drops the 128-lane window (the card gathers from L2) and
keeps S as one operator; sums add in other orders, hence the tolerances.
"""
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fem_elastoplasticity_tpu.models.materials import lame_moduli
from fem_elastoplasticity_tpu.models.tsx_tunnel import _DATA, tsx_mesh
from fem_elastoplasticity_tpu.ops import assembly as jasm
from fem_elastoplasticity_tpu.ops import assembly_df as jadf
from fem_elastoplasticity_tpu.ops import spmv as jspmv
from fem_elastoplasticity_tpu.ops.elements import ElementType, volume_element
from fem_elastoplasticity_tpu.solve import multigrid as jmg
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.models.tsx_tunnel import _free_of
from fem_elastoplasticity_tpu_torch.ops import assembly as pasm
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType as PElementType
from fem_elastoplasticity_tpu_torch.ops.elements import volume_element as pvolume_element
from fem_elastoplasticity_tpu_torch.utils.convert import geometry_from_df

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
ANCHOR_U40_L1 = -2.166787295662e-03  # tests/test_tsx_tunnel.py


@pytest.fixture(scope="module")
def jax_l1_ell():
    """The JAX package's level-1 ELL hierarchy: its fine K, P, R (scipy) and
    their windowed-ELL arrays and metas."""
    with np.load(_DATA) as raw:
        coords, elems = raw["coords"].astype(np.float64), raw["elems"]
    shear, bulk = lame_moduli(60000.0, 0.2)
    jarr, jmeta, _, jcoarse = jmg.build_hierarchy_ell(
        coords, elems, 1, _free_of, shear, bulk, volume_element(ElementType.P1),
        fmt="ell", collect_levels=True)
    P = jcoarse["levels"][-1]["P"]
    R = P.T.tocsr()
    R.sum_duplicates()
    csr = dict(K=jcoarse["levels"][-1]["K"], P=P, R=R)
    return {k: (csr[k], jarr[-1][k if k != "K" else "op"], jmeta[-1][k if k != "K" else "op"])
            for k in ("K", "P", "R")}


@pytest.mark.parametrize("which", ["K", "P", "R"])
def test_f32_plain_matches_jax_ell_matvec(jax_l1_ell, which):
    """The level-1 fine operator and its transfers: the JAX package's degree
    cap, and the product within 2e-6 of max |y| of `ell_matvec`'s."""
    M, arrays, meta = jax_l1_ell[which]
    A = pspmv.build_ell(M, "cpu", np.float32)
    assert A.cap == meta.deg and A.values.dtype == torch.float32
    assert A.n_slices == -(-M.shape[0] // pspmv.ELL_SLICE) and int(A.widths().max()) <= meta.deg
    widths = A.widths()
    assert A.width == (int(widths[0]) if bool((widths == widths[0]).all()) else 0)
    v = np.random.default_rng(5).standard_normal(M.shape[1]).astype(np.float32)
    exp = np.asarray(jax.jit(lambda a, vv: jspmv.ell_matvec(a, meta, vv))(arrays, jnp.asarray(v)))
    pspmv.LAUNCHES.clear()
    got = pspmv.sp_matvec(A, torch.as_tensor(v))
    assert pspmv.LAUNCHES == {"ell_spmv_f32_plain": 1}
    assert got.shape == (M.shape[0],) and got.dtype == torch.float32
    scale = np.abs(exp).max()
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=2e-6 * scale)
    np.testing.assert_allclose(got.numpy(), M @ v.astype(np.float64), rtol=0, atol=2e-6 * scale)


@pytest.fixture(scope="module")
def residual_l1():
    """The JAX package's df32 G/S on the RCM-ordered level-1 tsx mesh in
    the ELL format, and the port's f64 ELL G/S from the same geometry."""
    mesh = tsx_mesh(ElementType.P1, 1)
    order = jspmv.rcm_node_order(mesh.elems, mesh.n_nodes)
    c2, e2, _ = jspmv.permute_mesh(mesh.coords, mesh.elems, order)
    e2 = e2[np.argsort(e2.min(axis=1), kind="stable")]
    gdf = jadf.geometry_df(c2, e2, volume_element(ElementType.P1))
    jops = jspmv.build_residual_slot_df(gdf, fmt="ell")
    g = geometry_from_df(gdf.hi.B, gdf.B_lo, gdf.hi.weight, gdf.w_lo, gdf.hi.edofs,
                         gdf.hi.n_nodes, gdf.hi.n_q, gdf.hi.n_real)
    return jops, pspmv.residual_operators(g, "cpu", "ell"), g


def _split(x64):
    hi = x64.astype(np.float32)
    return hi, (x64 - hi.astype(np.float64)).astype(np.float32)


@pytest.mark.parametrize("name", ["G", "S"])
def test_f64_plain_matches_jax_ell_matvec_df(residual_l1, name):
    """G and S each as one sliced ELL operator (the JAX package splits S
    into three column parts, `SplitColsDfMeta`, one a strain component):
    G at the JAX package's degree cap, S at the cap of its own rows, and
    the products within 1e-13 normwise of the double-float ones."""
    (Ga, Gm, Sa, Sm), (G, S), g = residual_l1
    arrays, meta, A = (Ga, Gm, G) if name == "G" else (Sa, Sm, S)
    assert isinstance(A, pspmv.EllMatrix)
    if name == "G":
        assert A.cap == Gm.ell.deg
    else:
        assert len(Sm.metas) == 3 and A.shape == (2 * g.n_nodes, 3 * g.n_int)
        _, S_host = pspmv.build_residual_csr(
            g.B.numpy(), g.weight.numpy(), g.edofs.numpy(), g.n_q, g.n_nodes)
        assert A.cap == pspmv.ell_degree_cap(np.diff(S_host.indptr), S_host.nnz, 0.005)
        assert A.cap >= max(m.ell.deg for m in Sm.metas)
    rng = np.random.default_rng(5)
    x = rng.standard_normal(A.shape[1]) * (1e-3 if name == "G" else 1.0)
    hi, lo = _split(x)
    oh, ol = jax.jit(lambda a, h, l: jspmv.sp_matvec_df(a, meta, h, l))(arrays, hi, lo)
    exp = np.asarray(oh, np.float64) + np.asarray(ol, np.float64)
    pspmv.LAUNCHES.clear()
    got = pspmv.sp_matvec(A, torch.as_tensor(hi.astype(np.float64) + lo.astype(np.float64)))
    assert pspmv.LAUNCHES == {"ell_spmv_f64_plain": 1}
    rel = np.linalg.norm(got.numpy() - exp) / np.linalg.norm(exp)
    assert rel <= 1e-13, rel


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_degree_cap_spills_outlier_rows_exactly(dtype):
    """A banded operator with a few long rows, and a spill budget that the
    long rows' excess fits (max_overflow_frac 0.2): the cap is the JAX
    package's, the excess goes to the tails of those rows alone, and the
    product with them is the scipy product."""
    rng = np.random.default_rng(3)
    n = 600
    M = sp.diags([rng.standard_normal(n - abs(k)) for k in range(-3, 4)], range(-3, 4)).tolil()
    for row in (7, 300, 599):
        M[row, rng.choice(n, 90, replace=False)] = rng.standard_normal(90)
    M = M.tocsr()
    _, meta = jspmv.build_ell(M, np.float32, max_overflow_frac=0.2)
    A = pspmv.build_ell(M, "cpu", dtype, max_overflow_frac=0.2)
    deg_arr = np.diff(M.indptr)
    assert A.cap == meta.deg == pspmv.ell_degree_cap(deg_arr, M.nnz, 0.2) == 7
    tail_counts = (A.tail_ptr[1:] - A.tail_ptr[:-1]).numpy()
    assert np.flatnonzero(tail_counts).tolist() == [7, 300, 599]
    assert A.tail_values.numel() == int(np.maximum(deg_arr - meta.deg, 0).sum())
    x = rng.standard_normal(n).astype(dtype)
    got = pspmv.ell_matvec(A, torch.as_tensor(x))
    exp = M.astype(np.float64) @ x.astype(np.float64)
    tol = 2e-6 if dtype == np.float32 else 1e-14
    np.testing.assert_allclose(got.numpy(), exp, rtol=0, atol=tol * np.abs(exp).max())


def _banded_with_long_rows(rng, n=600):
    M = sp.diags([rng.standard_normal(n - abs(k)) for k in range(-3, 4)], range(-3, 4)).tolil()
    for row in (7, n // 2, n - 1):
        M[row, rng.choice(n, 90, replace=False)] = rng.standard_normal(90)
    return M.tocsr()


@pytest.mark.parametrize("frac", [0.005, 0.2], ids=["cap-full", "cap-7"])
def test_sliced_layout_slots_widths_and_tails(frac):
    """Each slice of 32 rows is as wide as its longest row up to the cap
    (`width` names the one width all slices share, if they do);
    slot j of a row holds its j-th entry in column order at slice_ptr + 32 j
    + lane, padding slots value 0 and column 0; the tail holds each row's
    entries past the cap, in order, and nothing else."""
    rng = np.random.default_rng(8)
    M = _banded_with_long_rows(rng)
    M.sort_indices()
    A = pspmv.build_ell(M, "cpu", np.float64, max_overflow_frac=frac)
    deg = np.diff(M.indptr)
    assert A.cap == pspmv.ell_degree_cap(deg, M.nnz, frac)
    assert A.cap == 7 if frac == 0.2 else A.cap > 90
    deg_pad = np.concatenate([deg, np.zeros(A.n_slices * 32 - M.shape[0], int)])
    widths = A.widths().numpy()
    assert widths.tolist() == np.minimum(deg_pad.reshape(-1, 32).max(axis=1), A.cap).tolist()
    assert A.slice_ptr.tolist() == [0, *np.cumsum(32 * widths).tolist()]
    # one width for every slice (the kernel then computes the offsets) at cap 7
    assert A.width == (widths[0] if (widths == widths[0]).all() else 0) == (
        7 if frac == 0.2 else 0)
    vals, cols, ptr = A.values.numpy(), A.cols.numpy(), A.slice_ptr.numpy()
    tptr = A.tail_ptr.numpy()
    for row in range(M.shape[0]):
        s, lane = divmod(row, 32)
        lo, hi = M.indptr[row], M.indptr[row + 1]
        pos = ptr[s] + 32 * np.arange(widths[s]) + lane
        n_slot = min(hi - lo, A.cap)
        assert (vals[pos[:n_slot]] == M.data[lo:lo + n_slot]).all()
        assert (cols[pos[:n_slot]] == M.indices[lo:lo + n_slot]).all()
        assert (vals[pos[n_slot:]] == 0).all() and (cols[pos[n_slot:]] == 0).all()
        t = slice(tptr[row], tptr[row + 1])
        assert (A.tail_values.numpy()[t] == M.data[lo + n_slot:hi]).all()
        assert (A.tail_cols.numpy()[t] == M.indices[lo + n_slot:hi]).all()


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_plain_adds_slots_then_tail_in_order(dtype):
    """The plain product sums a row's slots in order and then its tail,
    the order K6 takes: bitwise equal to that loop in numpy, and within
    rounding of the CSR product on the same operator."""
    rng = np.random.default_rng(9)
    M = _banded_with_long_rows(rng, 200)
    A = pspmv.build_ell(M, "cpu", dtype, max_overflow_frac=0.2)
    x = rng.standard_normal(M.shape[1]).astype(dtype)
    got = pspmv.ell_matvec(A, torch.as_tensor(x)).numpy()
    exp = np.zeros(M.shape[0], dtype)
    for row in range(M.shape[0]):
        acc = dtype(0)
        for k in range(M.indptr[row], M.indptr[row + 1]):
            acc = dtype(acc + dtype(dtype(M.data[k]) * x[M.indices[k]]))
        exp[row] = acc
    assert got.dtype == dtype and np.array_equal(got, exp)
    y_csr = pspmv.csr_matvec(pspmv.csr_to_device(M, "cpu", dtype), torch.as_tensor(x)).numpy()
    tol = 2e-6 if dtype == np.float32 else 1e-14
    np.testing.assert_allclose(got, y_csr, rtol=0, atol=tol * np.abs(y_csr).max())


def test_sp_matvec_dispatches_on_the_operator_type():
    M = sp.random(64, 40, density=0.1, random_state=2, format="csr")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(40))
    C = pspmv.csr_to_device(M, "cpu")
    E = pspmv.build_ell(M, "cpu", np.float64)
    pspmv.LAUNCHES.clear()
    yc, ye = pspmv.sp_matvec(C, x), pspmv.sp_matvec(E, x)
    assert pspmv.LAUNCHES == {"csr_spmv_f64_plain": 1, "ell_spmv_f64_plain": 1}
    np.testing.assert_allclose(ye.numpy(), yc.numpy(), rtol=0, atol=1e-14)
    with pytest.raises(TypeError):
        pspmv.sp_matvec(M, x)
    with pytest.raises(ValueError, match="CUDA"):
        pspmv.ell_spmv_cuda(E, x)


@pytest.mark.parametrize("dtype", [np.float32, np.float64], ids=["f32", "f64"])
def test_plastic_correction_apply_matches_jax(dtype):
    """The gathered correction B^T (w delta) B v on a plastic slot set of
    neighbouring points of the level-1 mesh (shared nodes), padding slots
    included: against the JAX package's `plastic_correction_apply`, within
    f32 / f64 rounding of max |y| (each node's sum in another order)."""
    mesh = tsx_mesh(ElementType.P1, 1)
    geom = pasm.compute_geometry(
        torch.as_tensor(mesh.coords, dtype=torch.float64), mesh.elems,
        pvolume_element(PElementType.P1)).to(torch.float32 if dtype == np.float32 else torch.float64)
    rng = np.random.default_rng(4)
    n_int, n_dofs = geom.n_int, 2 * geom.n_nodes
    ind_p = np.zeros(n_int, bool)
    ind_p[rng.choice(200, 80, replace=False)] = True  # nearby elements share nodes
    idx, valid = pasm.plastic_slots(torch.as_tensor(ind_p), 96)
    delta = rng.standard_normal((3, 3, n_int))
    delta = torch.as_tensor(delta + delta.transpose(1, 0, 2), dtype=geom.B.dtype)
    Bp, wdelta, edp = pasm.plastic_correction_gather(geom, delta, idx, valid)
    v = rng.standard_normal(n_dofs).astype(dtype)
    got = pasm.plastic_correction_apply(Bp, wdelta, edp, n_dofs, torch.as_tensor(v)).numpy()
    with jax.enable_x64(dtype == np.float64):
        exp = np.asarray(jasm.plastic_correction_apply(
            jnp.asarray(Bp.numpy()), jnp.asarray(wdelta.numpy()), jnp.asarray(edp.numpy()),
            n_dofs, jnp.asarray(v)))
    assert got.dtype == exp.dtype == dtype and got.shape == (n_dofs,)
    tol = 1e-6 if dtype == np.float32 else 1e-14
    np.testing.assert_allclose(got, exp, rtol=0, atol=tol * np.abs(exp).max())
    assert (np.abs(exp) > 0).sum() > 100


def test_ell_scale_slice_against_jax():
    """`fast_scale(1, spmv_fmt="ell", corr_mode="gather",
    residual_fmt="ell")`: the JAX package's steps, Newton iterations and
    plastic points, u within 1e-8; the CG total printed.  Every operator
    application is an ELL product, and no CSR product runs."""
    cfg = TsxTunnelConfig.fast_scale(1, spmv_fmt="ell", corr_mode="gather", residual_fmt="ell")
    pspmv.LAUNCHES.clear()
    r = tsx.solve(cfg, device="cpu")
    launches = dict(pspmv.LAUNCHES)
    exp = np.load(FIXTURES / "tsx_scale_l1_ell.npz")
    print(f"ELL L1: port {r.n_steps} / {r.n_newton_total} / {r.n_cg_total} CG / "
          f"{r.n_plastic}, JAX {int(exp['n_steps'])} / {int(exp['n_newton_total'])} / "
          f"{int(exp['n_cg_total'])} CG / {int(exp['n_plastic'])}")
    assert (r.n_steps, r.n_newton_total, r.n_plastic) == (
        int(exp["n_steps"]), int(exp["n_newton_total"]), int(exp["n_plastic"]))
    assert np.abs(r.u - exp["u"]).max() <= 1e-8 * np.abs(exp["u"]).max()
    assert abs(r.u[40, 0] - ANCHOR_U40_L1) / abs(ANCHOR_U40_L1) < 1e-8
    assert set(launches) == {"ell_spmv_f32_plain", "ell_spmv_f64_plain"}


@pytest.mark.parametrize("name,kw,kernels", [
    ("tsx_scale_l1_gather", dict(corr_mode="gather"),
     {"node_block_spmv_plain", "node_transfer_plain", "block_jacobi_sweep_plain",
      "csr_spmv_f64_plain"}),
    ("tsx_scale_l1_res_ell", dict(residual_fmt="ell"),
     {"node_block_spmv_plain", "node_transfer_plain", "block_jacobi_sweep_plain",
      "ell_spmv_f64_plain"}),
    ("tsx_scale_l1_ell_res_csr", dict(spmv_fmt="ell", corr_mode="gather"),
     {"ell_spmv_f32_plain", "csr_spmv_f64_plain"}),
], ids=["slot-gather", "slot-scatter-res_ell", "ell-gather-res_csr"])
def test_other_format_pairings_against_jax(name, kw, kernels):
    """The other pairings of `spmv_fmt`, `corr_mode` and `residual_fmt` on
    the level-1 scale preset, each against its JAX fixture: the JAX
    package's steps, Newton iterations and plastic points, the CG total
    within 5%, u within 1e-8; each operator in the format it names."""
    pspmv.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast_scale(1, **kw), device="cpu")
    launches = dict(pspmv.LAUNCHES)
    exp = np.load(FIXTURES / f"{name}.npz")
    print(f"{name}: port {r.n_steps} / {r.n_newton_total} / {r.n_cg_total} CG / "
          f"{r.n_plastic}, JAX {int(exp['n_steps'])} / {int(exp['n_newton_total'])} / "
          f"{int(exp['n_cg_total'])} CG / {int(exp['n_plastic'])}")
    assert (r.n_steps, r.n_newton_total, r.n_plastic) == (
        int(exp["n_steps"]), int(exp["n_newton_total"]), int(exp["n_plastic"]))
    assert abs(r.n_cg_total - int(exp["n_cg_total"])) <= 0.05 * int(exp["n_cg_total"])
    assert np.abs(r.u - exp["u"]).max() <= 1e-8 * np.abs(exp["u"]).max()
    assert abs(r.u[40, 0] - ANCHOR_U40_L1) / abs(ANCHOR_U40_L1) < 1e-8
    assert set(launches) == kernels
    assert r.n_plastic > 0  # the correction, gathered or scattered, was applied


def test_bench_preset_with_the_ell_residual_against_jax():
    """`fast(assembled_cg=True, residual_fmt="ell")`, the dense bench preset
    with its residual on ELL G/S (K6 f64): the JAX package's counts, and u,
    the monitor history and ep to the bench preset's own tolerances."""
    pspmv.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast(assembled_cg=True, residual_fmt="ell"), device="cpu")
    assert set(pspmv.LAUNCHES) == {"ell_spmv_f64_plain"}
    exp = np.load(FIXTURES / "tsx_df32_bench_res_ell.npz")
    assert (r.n_steps, r.n_newton_total, r.n_plastic) == (17, 28, 3) == (
        int(exp["n_steps"]), int(exp["n_newton_total"]), int(exp["n_plastic"]))
    scale = lambda a: np.abs(a).max()  # noqa: E731
    assert np.abs(r.u - exp["u"]).max() <= 1e-11 * scale(exp["u"])
    assert np.abs(r.displ_hist - exp["displ_hist"]).max() <= 1e-11 * scale(exp["displ_hist"])
    assert np.abs(r.ep - exp["ep"]).max() <= 1e-9 * scale(exp["ep"])


def test_scale_preset_takes_the_ell_format_only_with_the_gather_correction():
    """spmv_fmt="ell" with the scatter refresh is refused before any
    assembly: the refresh writes into a CSR value array, and the JAX
    package fails on the same pair."""
    cfg = TsxTunnelConfig.fast_scale(2, spmv_fmt="ell", corr_mode="gather", residual_fmt="ell",
                                     ell_overflow_frac=0.01)
    assert (cfg.spmv_fmt, cfg.corr_mode, cfg.residual_fmt) == ("ell", "gather", "ell")
    assert TsxTunnelConfig.fast_scale(1, corr_mode="gather").spmv_fmt == "slot"
    with pytest.raises(ValueError, match="gather"):
        TsxTunnelConfig.fast_scale(1, spmv_fmt="ell")
    with pytest.raises(ValueError):
        TsxTunnelConfig.fast_scale(1, spmv_fmt="ell", corr_mode="full")
    # the JAX package's slot layouts name the port's CSR residual route
    assert TsxTunnelConfig.fast_scale(1, residual_fmt="rslot").residual_fmt == "rslot"
    with pytest.raises(NotImplementedError):
        TsxTunnelConfig.fast_scale(1, residual_fmt="windowed")
    # the dense bench preset takes the ELL residual with its assembled G/S
    assert TsxTunnelConfig.fast(assembled_cg=True, residual_fmt="ell").residual_fmt == "ell"
