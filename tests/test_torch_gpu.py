"""PyTorch port on the card: kernels K1 to K7 against their plain versions.

Every test here needs a CUDA card and skips without one.  The file imports
no JAX, so on the card's machine (which has none) it runs without the
repository's conftest:

    python -m pytest --noconftest -q tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.models.materials import drucker_prager_fit, lame_moduli
from fem_elastoplasticity_tpu_torch.ops import assembly as asm
from fem_elastoplasticity_tpu_torch.ops import cholesky as chol
from fem_elastoplasticity_tpu_torch.ops import return_map as rm
from fem_elastoplasticity_tpu_torch.ops import spmv
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spmv.load_kernel()
    return torch.device("cuda")


@pytest.mark.parametrize("level", [0, 2])
def test_k1_matches_plain_on_tsx_operators(cuda, level):
    mesh = tsx.tsx_mesh(ElementType.P1, level)
    geom = asm.compute_geometry(
        torch.as_tensor(mesh.coords, device=cuda), mesh.elems, volume_element(ElementType.P1)
    )
    G, S = spmv.build_residual_csr(
        geom.B.cpu().numpy(), geom.weight.cpu().numpy(), geom.edofs.cpu().numpy(),
        geom.n_q, geom.n_nodes,
    )
    gen = torch.Generator(device=cuda).manual_seed(level)
    for A in (spmv.csr_to_device(G, cuda), spmv.csr_to_device(S, cuda)):
        x = torch.randn(A.shape[1], generator=gen, dtype=torch.float64, device=cuda)
        y = spmv.csr_matvec(A, x)
        y_plain = spmv.csr_matvec_plain(A, x)
        rel = torch.linalg.norm(y - y_plain) / torch.linalg.norm(y_plain)
        assert float(rel) <= 1e-13
        assert torch.equal(y, spmv.csr_matvec(A, x))  # fixed order, no atomics


def long_row_matrix():
    """(scipy CSR, x) with empty rows (first, inside, last), short rows and
    one row of 5 E entries (E = `spmv.ROW_BLOCK_ENTRIES`, walked in chunks
    of E), values and x small integers times powers of two: every partial
    sum is exact in f32 and f64, so any order gives the same y and the
    comparison checks that every entry is summed once."""
    import scipy.sparse as sp

    rng = np.random.default_rng(11)
    n_cols = 12_000
    deg = np.concatenate([[0, 3, 0, 5 * spmv.ROW_BLOCK_ENTRIES, 7, 0],
                          rng.integers(0, 40, 3000), [0, 0]])
    indptr = np.concatenate([[0], np.cumsum(deg)])
    indices = np.concatenate([np.sort(rng.choice(n_cols, d, replace=False)) for d in deg])
    # products are multiples of 2^-3 of at most 16, partial sums below 2^18: exact in f32
    values = rng.integers(-4, 5, indptr[-1]) * 2.0 ** rng.integers(-2, 1, indptr[-1])
    x = rng.integers(-4, 5, n_cols) * 2.0 ** rng.integers(-1, 1, n_cols)
    return sp.csr_matrix((values, indices, indptr), shape=(deg.shape[0], n_cols)), x


def test_k1_empty_rows_and_wrong_inputs(cuda):
    import scipy.sparse as sp

    A = sp.csr_matrix(np.array([[0.0, 2.0], [0.0, 0.0], [1.0, 3.0]]))
    At = spmv.csr_to_device(A, cuda)
    x = torch.tensor([1.5, -2.0], dtype=torch.float64, device=cuda)
    np.testing.assert_array_equal(spmv.csr_spmv_f64_cuda(At, x).cpu().numpy(), A @ x.cpu().numpy())
    L, xl = long_row_matrix()
    Lt = spmv.csr_to_device(L, cuda)
    assert Lt.row_blocks.shape[0] > 2
    y = spmv.csr_spmv_f64_cuda(Lt, torch.as_tensor(xl, device=cuda))
    np.testing.assert_array_equal(y.cpu().numpy(), L @ xl)
    with pytest.raises(ValueError):
        spmv.csr_spmv_f64_cuda(At, x.float())
    with pytest.raises(ValueError):
        spmv.csr_spmv_f64_cuda(At, torch.zeros(3, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError):  # no row blocks: not made by csr_to_device
        spmv.csr_spmv_f64_cuda(At._replace(row_blocks=None), x)
    with pytest.raises(ValueError):  # row blocks off the card
        spmv.csr_spmv_f64_cuda(At._replace(row_blocks=At.row_blocks.cpu()), x)


def test_bench_solve_runs_through_k1(cuda):
    spmv.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast(assembled_cg=True), device=cuda)
    assert spmv.LAUNCHES["csr_spmv_f64"] > 0 and spmv.LAUNCHES["csr_spmv_f64_plain"] == 0
    assert (r.n_steps, r.n_newton_total) == (17, 28)
    assert abs(r.u[40, 0] + 1.9794499636012143e-03) / 1.9794499636012143e-03 < 1e-9


@pytest.fixture(scope="module")
def cuda_k2():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    rm.load_kernel()
    return torch.device("cuda")


@pytest.mark.parametrize("n", [896, 1000])
@pytest.mark.parametrize("apex", [False, True])
@pytest.mark.parametrize("apply", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
def test_k2_matches_plain(cuda_k2, dtype, apply, apex, n):
    """Seeded inputs of the JAX test's distributions, tsx material; n = 1000
    is no multiple of the block size.  Both are built to round alike
    (-fmad=false): s, D, ind_p, lam and ep of one launch are bitwise the
    plain version with e0 = e0_dir * zeta, `unpack_tangent` and `lam > 0`
    (so within the smoke run's bound too: 1e-6 of max |plain| in f32, 1e-13
    in f64); `dp_return_map_fused` gives the plain ds6."""
    shear, bulk = lame_moduli(60000.0, 0.2)
    eta, c = drucker_prager_fit(18.7, 49 * np.pi / 180)
    rng = np.random.default_rng(n)
    e3 = torch.as_tensor(rng.normal(0, 2e-3, (3, n)), dtype=dtype, device=cuda_k2)
    ep = torch.as_tensor(rng.normal(0, 2e-4, (4, n)), dtype=dtype, device=cuda_k2)
    e0_dir = torch.as_tensor(rng.normal(0, 1e-3, 4), dtype=dtype, device=cuda_k2)
    zeta = float(np.float32(7 / 17))
    got = rm.dp_return_map_cuda(e3, ep, shear, bulk, eta, c, e0_dir, zeta, apply, apex)
    ps, pds6, plam, pep = rm.dp_return_map_plain(e3, ep, shear, bulk, eta, c, e0_dir, zeta,
                                                 apply, apex)
    exp = (ps, rm.unpack_tangent(pds6), plam > 0.0, plam, pep)
    torch.cuda.synchronize()
    tol = 1e-6 if dtype == torch.float32 else 1e-13
    for g, x in zip(got, exp):
        assert g.shape == x.shape and g.dtype == x.dtype
        assert torch.equal(g, x)
        if x.dtype != torch.bool:
            assert float((g - x).abs().max()) <= tol * float(x.abs().max())
    assert 0 < int(got[2].sum()) < n
    fused = rm.dp_return_map_fused(e3, ep, shear, bulk, eta, c, e0_dir * zeta, apply, apex)
    assert all(torch.equal(g, x) for g, x in zip(fused, (ps, pds6, plam, pep)))
    again = rm.dp_return_map_cuda(e3, ep, shear, bulk, eta, c, e0_dir, zeta, apply, apex)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_k2_refuses_wrong_inputs(cuda_k2):
    e3 = torch.zeros((3, 8), device=cuda_k2)
    ep = torch.zeros((4, 8), device=cuda_k2)
    args = (1.0, 1.0, 0.5, 1.0)
    with pytest.raises(ValueError):  # dtype mismatch
        rm.dp_return_map_cuda(e3, ep.double(), *args)
    with pytest.raises(ValueError):  # shape
        rm.dp_return_map_cuda(e3, ep[:3], *args)
    with pytest.raises(ValueError):  # contiguity
        rm.dp_return_map_cuda(torch.zeros((8, 3), device=cuda_k2).T, ep, *args)
    with pytest.raises(ValueError):  # device
        rm.dp_return_map_cuda(e3, ep.cpu(), *args)
    with pytest.raises(ValueError):  # integer input
        rm.dp_return_map_cuda(e3.int(), ep.int(), *args)
    with pytest.raises(ValueError):  # e0_dir of another dtype
        rm.dp_return_map_cuda(e3, ep, *args, torch.zeros(4, device=cuda_k2).double())
    with pytest.raises(ValueError):  # e0_dir of another shape
        rm.dp_return_map_cuda(e3, ep, *args, torch.zeros(3, device=cuda_k2))


@pytest.mark.parametrize("n", [896, 1000])
@pytest.mark.parametrize("apex", [False, True])
@pytest.mark.parametrize("apply", [False, True])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_k2_batched_matches_single_launches(cuda_k2, dtype, apply, apex, n):
    """K2's member-batched instance over 5 materials, each with its own
    zeta: member b's s, D, ind_p, lam and ep are `torch.equal` to a single
    K2 launch with its eta, c and zeta, and to the batched plain version;
    two launches bit-identical."""
    shear, bulk = lame_moduli(60000.0, 0.2)
    mats = [drucker_prager_fit(cc, ff * np.pi / 180)
            for cc, ff in ((18.7, 49), (14.0, 40), (25.0, 55), (4.0, 45), (20.0, 50))]
    zetas = [float(np.float32(k / 17)) for k in (7, 1, 17, 12, 3)]
    rng = np.random.default_rng(n + 1)
    e3 = torch.as_tensor(rng.normal(0, 2e-3, (5, 3, n)), dtype=dtype, device=cuda_k2)
    ep = torch.as_tensor(rng.normal(0, 2e-4, (5, 4, n)), dtype=dtype, device=cuda_k2)
    e0_dir = torch.as_tensor(rng.normal(0, 1e-3, 4), dtype=dtype, device=cuda_k2)
    params = torch.tensor([[e, c, z] for (e, c), z in zip(mats, zetas)], dtype=torch.float64,
                          device=cuda_k2)
    rm.LAUNCHES.clear()
    got = rm.dp_return_map_batched_cuda(e3, ep, shear, bulk, params, e0_dir, apply, apex)
    assert dict(rm.LAUNCHES) == {"dp_return_map_batched": 1}
    for b, ((eta, c), zeta) in enumerate(zip(mats, zetas)):
        one = rm.dp_return_map_cuda(e3[b], ep[b], shear, bulk, eta, c, e0_dir, zeta, apply, apex)
        assert all(torch.equal(g[b], o) for g, o in zip(got, one))
    s, ds6, lam, ep_ = rm.dp_return_map_plain_batched(e3, ep, shear, bulk, params, e0_dir, apply,
                                                      apex)
    exp = (s, rm.unpack_tangent(ds6), lam > 0.0, lam, ep_)
    assert all(torch.equal(g, x) for g, x in zip(got, exp))
    again = rm.dp_return_map_batched_cuda(e3, ep, shear, bulk, params, e0_dir, apply, apex)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    assert 0 < int(got[2].sum()) < got[2].numel()


def test_k2_batched_refuses_wrong_inputs(cuda_k2):
    e3 = torch.zeros((2, 3, 8), device=cuda_k2)
    ep = torch.zeros((2, 4, 8), device=cuda_k2)
    params = torch.ones((2, 3), dtype=torch.float64, device=cuda_k2)
    with pytest.raises(ValueError):  # params not f64
        rm.dp_return_map_batched_cuda(e3, ep, 1.0, 1.0, params.float())
    with pytest.raises(ValueError):  # one member short
        rm.dp_return_map_batched_cuda(e3, ep[:1], 1.0, 1.0, params)
    with pytest.raises(ValueError):  # params of another member count
        rm.dp_return_map_batched_cuda(e3, ep, 1.0, 1.0, params[:1])
    with pytest.raises(ValueError):  # single-member shape
        rm.dp_return_map_batched_cuda(e3[0], ep[0], 1.0, 1.0, params)
    with pytest.raises(ValueError):  # device
        rm.dp_return_map_batched_cuda(e3, ep, 1.0, 1.0, params.cpu())
    with pytest.raises(ValueError):  # contiguity
        rm.dp_return_map_batched_cuda(e3.transpose(0, 1).contiguous().transpose(0, 1), ep, 1.0,
                                      1.0, params)
    with pytest.raises(ValueError):  # a CPU tensor never routes to the plain version here
        rm.dp_return_map_batched_cuda(e3.cpu(), ep.cpu(), 1.0, 1.0, params.cpu())


def test_f32_ensemble_runs_through_batched_k2(cuda_k2):
    """A 4-member f32 ensemble: K2's batched instance is the only return
    map route (no single launch, no plain version); every member ends with
    its single f32 solve's steps, Newton iterations and plastic points."""
    from fem_elastoplasticity_tpu_torch.parallel import ensemble as ens

    coh, fr = np.array([4.0, 18.7]), np.array([40.0, 49.0]) * np.pi / 180
    eta, c = ens.material_grid(coh, fr)
    rm.LAUNCHES.clear()
    e = ens.solve_tsx_ensemble(eta, c, TsxTunnelConfig.fast_f32(), device=cuda_k2)
    launches = dict(rm.LAUNCHES)
    assert set(launches) == {"dp_return_map_batched"}
    assert int(e.n_newton_total.max()) < launches["dp_return_map_batched"]
    for k, (cc, ff) in enumerate((a, b) for a in coh for b in fr):
        r = tsx.solve(TsxTunnelConfig.fast_f32(cohesion=float(cc), friction_angle=float(ff)),
                      device=cuda_k2)
        assert (int(e.n_steps[k]), int(e.n_newton_total[k]), int(e.n_plastic[k])) == (
            r.n_steps, r.n_newton_total, r.n_plastic)
        assert np.abs(e.u[k] - r.u).max() <= 1e-5 * np.abs(r.u).max()


def test_f32_solves_run_through_k2(cuda_k2):
    rm.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast_f32(), device=cuda_k2)
    assert rm.LAUNCHES["dp_return_map"] > 0 and rm.LAUNCHES["dp_return_map_plain"] == 0
    assert r.n_steps == 17
    assert abs(r.u[40, 0] + 1.9794499636012143e-03) / 1.9794499636012143e-03 < 1e-5
    rm.LAUNCHES.clear()
    rf = footing.solve(FootingConfig.fast_f32(), device=cuda_k2)
    assert rm.LAUNCHES["dp_return_map"] > 0 and rm.LAUNCHES["dp_return_map_plain"] == 0
    assert rf.zeta_hist[rf.n_steps] >= 1.0
    assert abs(rf.pressure_hist[rf.n_steps] - 16.836351573454152) / 16.836351573454152 < 5e-4


@pytest.fixture(scope="module")
def cuda_scale():
    """The card with K1, K3 (its node kernels and its earlier CSR one), K4
    and K6 built; the level-1 hierarchy on it; and its fine level's
    operator and transfers as f32 CSR on the card (the hierarchy keeps
    none), {"K", "P", "R"}."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    spmv.load_kernel()
    spmv.load_sweep_kernel()
    spmv.load_transfer_kernel()
    spmv.load_ell_kernel()
    device = torch.device("cuda")
    extras = {}
    tsx.build_df32(TsxTunnelConfig.fast_scale(1), device=device, extras=extras)
    top = extras["host_levels"][-1]
    P = top["P"].tocsr()
    R = P.T.tocsr()
    R.sum_duplicates()
    csr = {k: spmv.csr_to_device(A, device, np.float32) for k, A in (("K", top["K"]), ("P", P),
                                                                       ("R", R))}
    return device, extras["hierarchy"], csr


@pytest.mark.parametrize("which", ["K", "P", "R"])
def test_k3_matches_plain(cuda_scale, which):
    """K3's earlier design, the f32 CSR kernel, square (the fine elastic
    operator) and rectangular (the transfers): the kernel and the plain
    version differ by the order of the row sum."""
    device, _, csr = cuda_scale
    A = csr[which]
    rng = np.random.default_rng(3)
    x = torch.as_tensor(rng.standard_normal(A.shape[1]).astype(np.float32), device=device)
    y = spmv.csr_matvec(A, x)
    y_plain = spmv.csr_matvec_plain(A, x)
    assert y.dtype == torch.float32 and y.shape == (A.shape[0],)
    assert float((y - y_plain).abs().max()) <= 2e-6 * float(y_plain.abs().max())
    assert torch.equal(y, spmv.csr_matvec(A, x))  # fixed order, no atomics
    # a new value array on the same structure, as the tangent refresh passes it
    A2 = A._replace(values=(2.0 * A.values).contiguous())
    assert torch.equal(spmv.csr_matvec(A2, x), 2.0 * y)


def test_k3_refuses_wrong_inputs(cuda_scale):
    device, _, csr = cuda_scale
    A = csr["K"]
    x = torch.zeros(A.shape[1], dtype=torch.float32, device=device)
    with pytest.raises(ValueError):  # dtype
        spmv.csr_spmv_f32_cuda(A, x.double())
    with pytest.raises(ValueError):  # shape
        spmv.csr_spmv_f32_cuda(A, x[:-1])
    with pytest.raises(ValueError):  # contiguity
        spmv.csr_spmv_f32_cuda(A, torch.zeros(2 * A.shape[1], device=device)[::2])
    with pytest.raises(ValueError):  # device
        spmv.csr_spmv_f32_cuda(A, x.cpu())
    with pytest.raises(ValueError):  # f64 values through the f32 kernel
        spmv.csr_spmv_f32_cuda(A._replace(values=A.values.double()), x)
    with pytest.raises(ValueError):  # no row blocks: not made by csr_to_device
        spmv.csr_spmv_f32_cuda(A._replace(row_blocks=None), x)
    # empty rows and a row longer than E, every partial sum exact
    L, xl = long_row_matrix()
    Lt = spmv.csr_to_device(L, device, np.float32)
    y = spmv.csr_spmv_f32_cuda(Lt, torch.as_tensor(xl, dtype=torch.float32, device=device))
    np.testing.assert_array_equal(y.cpu().numpy(), (L @ xl).astype(np.float32))


@pytest.mark.parametrize("update", [True, False], ids=["update", "residual"])
def test_k4_matches_plain(cuda_scale, update):
    """K4 on the level-1 fine operator's node blocks: bit for bit its plain
    version on the blocks (the same order of summation), within 5e-6 of the
    plain version on the CSR, constrained rows exact, launches
    bit-identical."""
    device, hier, csr = cuda_scale
    lev = hier.levels[-1]
    B = lev.sweep_op
    assert B.block_values.dtype == torch.float32
    n = B.shape[0]
    rng = np.random.default_rng(4)
    z = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
    r = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
    r = r * spmv.csr_matvec_plain(csr["K"], z).abs().max()
    got = spmv.block_jacobi_sweep(B, lev.aux, z, r, update)
    assert torch.equal(got, spmv.node_block_sweep_plain(B, lev.aux, z, r, update))
    exp = spmv.block_jacobi_sweep_plain(csr["K"], lev.aux, z, r, update)
    assert float((got - exp).abs().max()) <= 5e-6 * float(exp.abs().max())
    fixed = lev.aux.mask == 0
    assert int(fixed.sum()) > 0
    assert torch.equal(got[fixed], z[fixed] if update else torch.zeros_like(z[fixed]))
    assert torch.equal(got, spmv.block_jacobi_sweep(B, lev.aux, z, r, update))


@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("update", [True, False], ids=["update", "residual"])
def test_k4_split_z_matches_plain_and_the_whole_sweep(cuda_scale, update, n):
    """K4's split-z instance on the level-1 fine operator cut into n row
    slices (`spmv.shard_rows`): each slice's launch is bit for bit its plain
    version and the unsharded launch's rows, counted as the split instance;
    the slice of rank 0 (node_offset 0) too."""
    from fem_elastoplasticity_tpu_torch.parallel.sharding import ShardGroup

    device, hier, _ = cuda_scale
    lev = hier.levels[-1]
    B = lev.sweep_op
    rng = np.random.default_rng(5)
    z = torch.as_tensor(rng.standard_normal(B.shape[0]).astype(np.float32), device=device)
    r = torch.as_tensor(rng.standard_normal(B.shape[0]).astype(np.float32), device=device)
    whole = spmv.block_jacobi_sweep(B, lev.aux, z, r, update)
    spmv.LAUNCHES.clear()
    for rank in range(n):
        part = spmv.shard_rows(B, ShardGroup(rank, n, device, "gloo"))
        rows = slice(part.row0, part.row0 + part.rows)
        aux = spmv.SweepAux(*(a[rows] for a in lev.aux))
        got = spmv.block_jacobi_sweep(part.local, aux, z, r[rows], update)
        assert part.local.node_offset == part.row0 // 2
        assert torch.equal(got, spmv.node_block_sweep_plain(part.local, aux, z, r[rows], update))
        assert torch.equal(got, whole[rows])
    assert dict(spmv.LAUNCHES) == {"block_jacobi_sweep_split": n}


def test_k4_node_offset_zero_keeps_the_unsharded_bits(cuda_scale):
    """With node_offset 0 on a whole operator the launch is the unsharded
    sweep: counted as K4, bit for bit the plain version on the blocks (which
    the earlier K4 matched bit for bit), on every level of the hierarchy."""
    device, hier, _ = cuda_scale
    rng = np.random.default_rng(6)
    for lev in hier.levels[1:]:
        B = lev.sweep_op
        assert B.node_offset == 0 and not B.is_slice
        z = torch.as_tensor(rng.standard_normal(B.shape[0]).astype(np.float32), device=device)
        r = torch.as_tensor(rng.standard_normal(B.shape[0]).astype(np.float32), device=device)
        spmv.LAUNCHES.clear()
        for update in (True, False):
            got = spmv.block_jacobi_sweep(B, lev.aux, z, r, update)
            assert torch.equal(got, spmv.node_block_sweep_plain(B, lev.aux, z, r, update))
        assert dict(spmv.LAUNCHES) == {"block_jacobi_sweep": 2}


def test_sharded_scale_on_the_card_is_bitwise_single_card(cuda_scale):
    """Two ranks on the card (gloo over cuda:0 tensors) run the row-sharded
    scale preset bit for bit as the single-card build does."""
    from fem_elastoplasticity_tpu_torch.parallel import sharding

    device = cuda_scale[0]
    cfg = TsxTunnelConfig.fast_scale(1, zeta_max=3 / 17)
    r1 = tsx.solve(cfg, device=device)
    assert sharding.placement(2)[1] == ("nccl" if torch.cuda.device_count() >= 2 else "gloo")
    r = tsx.solve_sharded_scale(cfg, 2)
    assert (r.n_steps, r.n_newton_total, r.n_cg_total) == (
        r1.n_steps, r1.n_newton_total, r1.n_cg_total)
    np.testing.assert_array_equal(r.zeta_hist, r1.zeta_hist)
    np.testing.assert_array_equal(r.u, r1.u)


def test_k4_and_its_plain_version_replay_in_a_cuda_graph(cuda_scale):
    """The kernel and its plain version on the blocks are captured in a CUDA
    graph, as `chip_smoke.py` times them: neither may read the card from
    the host (the plain version pads to the layout's stored width), and the
    replays give the eager bits."""
    device, hier, _ = cuda_scale
    lev = hier.levels[-1]
    B = lev.sweep_op
    n = 2 * B.n_nodes
    rng = np.random.default_rng(6)
    z = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
    r = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
    for fn in (spmv.block_jacobi_sweep_cuda, spmv.node_block_sweep_plain):
        eager = fn(B, lev.aux, z, r, True)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(B, lev.aux, z, r, True)  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn(B, lev.aux, z, r, True)
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), fn.__name__


def test_k4_refuses_wrong_inputs_and_aliasing(cuda_scale):
    device, hier, csr = cuda_scale
    lev = hier.levels[-1]
    B = lev.sweep_op
    n = B.shape[0]
    z = torch.zeros(n, dtype=torch.float32, device=device)
    r = torch.ones(n, dtype=torch.float32, device=device)
    with pytest.raises(ValueError):  # out aliases z: the sweep is Jacobi
        spmv.block_jacobi_sweep_cuda(B, lev.aux, z, r, out=z)
    with pytest.raises(ValueError):  # dtype
        spmv.block_jacobi_sweep_cuda(B, lev.aux, z, r.double())
    with pytest.raises(ValueError):  # shape
        spmv.block_jacobi_sweep_cuda(B, lev.aux, z, r[:-2])
    with pytest.raises(ValueError):  # device
        spmv.block_jacobi_sweep_cuda(B, lev.aux, z, r.cpu())
    with pytest.raises(ValueError):  # the CSR operator: the sweep reads node blocks only
        spmv.block_jacobi_sweep_cuda(csr["K"], lev.aux, z, r)
    with pytest.raises(ValueError):  # a rectangular operator has no 2x2 node blocks
        spmv.node_blocks(csr["P"])
    misaligned = B.block_values.new_zeros(B.block_values.numel() + 2)[2:].view(-1, 4)
    with pytest.raises(ValueError):  # f32 block values off their 16-byte alignment
        spmv.block_jacobi_sweep_cuda(B._replace(block_values=misaligned), lev.aux, z, r)
    out = torch.empty_like(z)
    assert spmv.block_jacobi_sweep_cuda(B, lev.aux, z, r, out=out) is out


def test_node_blocks_raise_on_the_card(cuda_scale):
    """The layout builder refuses an unsorted or non-blocked operator on the
    card as on the CPU: no route back to a CSR sweep."""
    _, _, csr = cuda_scale
    A = csr["K"]
    spmv.node_blocks(A)
    idx = A.indices.clone()
    lo, hi = int(A.indptr[5]), int(A.indptr[6])
    idx[lo:hi] = idx[lo:hi].flip(0)
    with pytest.raises(ValueError, match="ascend"):
        spmv.node_blocks(A._replace(indices=idx))
    # row 0 loses its first entry's node column where row 1 keeps it
    lo, hi = int(A.indptr[0]), int(A.indptr[1])
    first = int(A.indices[lo]) // 2
    keep = torch.ones(A.indices.shape[0], dtype=torch.bool, device=A.indices.device)
    keep[lo:hi] = A.indices[lo:hi] // 2 != first
    dropped = int(hi - lo - keep[lo:hi].sum())
    indptr = A.indptr.clone()
    indptr[1:] -= dropped
    with pytest.raises(ValueError, match="differ"):
        spmv.node_blocks(spmv.CsrMatrix(indptr, A.indices[keep].contiguous(),
                                        A.values[keep].contiguous(), A.shape))


def test_scale_solve_runs_through_k3_k4_k1(cuda_scale):
    device, _, _ = cuda_scale
    spmv.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast_scale(1), device=device)
    for name in ("node_block_spmv", "node_transfer", "block_jacobi_sweep", "csr_spmv_f64"):
        assert spmv.LAUNCHES[name] > 0, name
    assert not any(v for k, v in spmv.LAUNCHES.items() if k.endswith("_plain"))
    assert spmv.LAUNCHES["csr_spmv_f32"] == 0  # no CSR operator on the path
    assert (r.n_steps, r.n_plastic) == (17, 20)
    assert abs(r.u[40, 0] + 2.166787295662e-03) / 2.166787295662e-03 < 1e-8


@pytest.mark.parametrize("update", [True, False], ids=["update", "residual"])
def test_k5_matches_plain_and_k4_on_rounded_values(cuda_scale, update):
    """K5 on the level-1 fine operator's bf16 values: within 5e-6 of its
    plain version, bit for bit K4 on the same values widened to f32 (one
    template, one order), constrained rows exact, launches bit-identical."""
    device, hier, csr = cuda_scale
    lev = hier.levels[-1]
    A = csr["K"]
    pk = spmv.node_blocks(A, torch.bfloat16)
    widened = pk._replace(block_values=pk.block_values.to(torch.float32).contiguous())
    widened_csr = A._replace(values=A.values.to(torch.bfloat16).to(torch.float32))
    n = A.shape[0]
    rng = np.random.default_rng(5)
    z = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
    r = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
    r = r * spmv.csr_matvec_plain(A, z).abs().max()
    spmv.LAUNCHES.clear()
    got = spmv.block_jacobi_sweep(pk, lev.aux, z, r, update)
    assert spmv.LAUNCHES == {"block_jacobi_sweep_bf16": 1}
    assert torch.equal(got, spmv.node_block_sweep_plain(pk, lev.aux, z, r, update))
    exp = spmv.block_jacobi_sweep_plain(widened_csr, lev.aux, z, r, update)
    assert float((got - exp).abs().max()) <= 5e-6 * float(exp.abs().max())
    assert torch.equal(got, spmv.block_jacobi_sweep_cuda(widened, lev.aux, z, r, update))
    fixed = lev.aux.mask == 0
    assert torch.equal(got[fixed], z[fixed] if update else torch.zeros_like(z[fixed]))
    assert torch.equal(got, spmv.block_jacobi_sweep(pk, lev.aux, z, r, update))
    y = spmv.packed_matvec(pk, z)
    assert float((y - spmv.csr_matvec_plain(widened_csr, z)).abs().max()) <= 2e-6 * float(y.abs().max())


def test_node_block_product_matches_plain_and_the_csr_kernel(cuda_scale):
    """K3's product on the level-1 fine operator's f32 node blocks: bit for
    bit its plain version and the CSR kernel (its earlier design) on the
    same operator and vector, launches bit-identical; a new value array on
    the same blocks, as the tangent refresh passes it, scales exactly."""
    device, hier, csr = cuda_scale
    B = hier.levels[-1].op
    assert B.block_values.dtype == torch.float32
    x = torch.as_tensor(np.random.default_rng(12).standard_normal(B.shape[0]).astype(np.float32),
                        device=device)
    spmv.LAUNCHES.clear()
    y = spmv.sp_matvec(B, x)
    assert spmv.LAUNCHES == {"node_block_spmv": 1}
    assert torch.equal(y, spmv.node_block_matvec_plain(B, x))
    assert torch.equal(y, spmv.csr_spmv_f32_cuda(csr["K"], x))
    assert torch.equal(y, spmv.node_block_matvec(B, x))
    B2 = B._replace(block_values=(2.0 * B.block_values).contiguous())
    assert torch.equal(spmv.node_block_matvec(B2, x), 2.0 * y)


@pytest.mark.parametrize("mode", ["plain", "masked", "masked_add"])
@pytest.mark.parametrize("which", ["P", "R"])
def test_node_transfer_matches_plain_and_the_csr_kernel(cuda_scale, which, mode):
    """K3's transfer kernel on the level-1 hierarchy's P and R in each
    mode: bit for bit its plain version, and the CSR kernel followed by
    `torch.where` (and the add), as the V-cycle ran them before."""
    device, hier, csr = cuda_scale
    T = getattr(hier.levels[-1], which)
    mask = {"P": hier.levels[-1].free, "R": hier.levels[0].free}[which]
    rng = np.random.default_rng(13)
    x = torch.as_tensor(rng.standard_normal(T.shape[1]).astype(np.float32), device=device)
    z = torch.as_tensor(rng.standard_normal(T.shape[0]).astype(np.float32), device=device)
    mask, z = {"plain": (None, None), "masked": (mask, None), "masked_add": (mask, z)}[mode]
    spmv.LAUNCHES.clear()
    y = spmv.transfer(T, x, mask, z)
    assert spmv.LAUNCHES == {"node_transfer": 1}
    assert torch.equal(y, spmv.node_transfer_plain(T, x, mask, z))
    want = spmv.csr_spmv_f32_cuda(csr[which], x)
    if mask is not None:
        want = torch.where(mask, want, torch.zeros((), device=device))
    if z is not None:
        want = z + want
    assert torch.equal(y, want)
    assert torch.equal(y, spmv.transfer(T, x, mask, z))


def test_k3_node_kernels_and_plain_versions_replay_in_a_cuda_graph(cuda_scale):
    """Both node kernels of K3 and their plain versions are captured in a
    CUDA graph, as `chip_smoke.py` times them: none reads the card from the
    host, and the replays give the eager bits."""
    device, hier, _ = cuda_scale
    fine, coarse = hier.levels[-1], hier.levels[0]
    rng = np.random.default_rng(14)
    x = torch.as_tensor(rng.standard_normal(fine.op.shape[0]).astype(np.float32), device=device)
    xc = torch.as_tensor(rng.standard_normal(fine.P.shape[1]).astype(np.float32), device=device)
    calls = [lambda: spmv.node_block_spmv_cuda(fine.op, x),
             lambda: spmv.node_block_matvec_plain(fine.op, x),
             lambda: spmv.node_transfer_cuda(fine.P, xc, fine.free, x),
             lambda: spmv.node_transfer_plain(fine.P, xc, fine.free, x),
             lambda: spmv.node_transfer_cuda(fine.R, x, coarse.free),
             lambda: spmv.node_transfer_plain(fine.R, x, coarse.free)]
    for i, fn in enumerate(calls):
        eager = fn()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn()  # warm-up outside the capture
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out = fn()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, eager), i


def test_k3_node_kernels_refuse_wrong_inputs_and_aliasing(cuda_scale):
    device, hier, csr = cuda_scale
    fine, coarse = hier.levels[-1], hier.levels[0]
    B, P, R = fine.op, fine.P, fine.R
    x = torch.zeros(B.shape[0], dtype=torch.float32, device=device)
    xc = torch.zeros(P.shape[1], dtype=torch.float32, device=device)
    spmv.LAUNCHES.clear()
    with pytest.raises(ValueError):  # dtype
        spmv.node_block_spmv_cuda(B, x.double())
    with pytest.raises(ValueError):  # shape
        spmv.node_block_spmv_cuda(B, x[:-2])
    with pytest.raises(ValueError):  # device
        spmv.node_block_spmv_cuda(B, x.cpu())
    with pytest.raises(ValueError):  # out aliases x
        spmv.node_block_spmv_cuda(B, x, out=x)
    with pytest.raises(ValueError):  # bf16 blocks: no product kernel
        spmv.node_block_spmv_cuda(B._replace(block_values=B.block_values.to(torch.bfloat16)), x)
    with pytest.raises(ValueError):  # a CSR operator
        spmv.node_block_spmv_cuda(csr["K"], x)
    misaligned = B.block_values.new_zeros(B.block_values.numel() + 2)[2:].view(-1, 4)
    with pytest.raises(ValueError):  # f32 block values off their 16-byte alignment
        spmv.node_block_spmv_cuda(B._replace(block_values=misaligned), x)
    with pytest.raises(ValueError):  # dtype
        spmv.node_transfer_cuda(P, xc.double())
    with pytest.raises(ValueError):  # shape: R's input to P
        spmv.node_transfer_cuda(P, x)
    with pytest.raises(ValueError):  # device
        spmv.node_transfer_cuda(R, x.cpu())
    with pytest.raises(ValueError):  # a float mask
        spmv.node_transfer_cuda(R, x, coarse.free.float())
    with pytest.raises(ValueError):  # the mask of the wrong level
        spmv.node_transfer_cuda(R, x, fine.free)
    with pytest.raises(ValueError):  # z without a mask
        spmv.node_transfer_cuda(P, xc, None, x)
    with pytest.raises(ValueError):  # out aliases z
        spmv.node_transfer_cuda(P, xc, fine.free, x, out=x)
    with pytest.raises(ValueError):  # a CSR transfer
        spmv.node_transfer_cuda(csr["P"], xc)
    assert not spmv.LAUNCHES
    out = torch.empty_like(x)
    assert spmv.node_block_spmv_cuda(B, xc.new_zeros(B.shape[0]), out=out) is out


@pytest.fixture(scope="module")
def cuda_ell(cuda_scale):
    """The level-1 ELL hierarchy and the ELL residual operators on the card."""
    device, _, _ = cuda_scale
    extras = {}
    cfg = TsxTunnelConfig.fast_scale(1, spmv_fmt="ell", corr_mode="gather", residual_fmt="ell")
    tsx.build_df32(cfg, device=device, extras=extras)
    return device, extras["hierarchy"], extras["residual_op"]


@pytest.mark.parametrize("which", ["K", "P", "R", "G", "S"])
def test_k6_matches_plain(cuda_ell, which):
    """f32 (the fine operator and its transfers) within 2e-6 of max |y|,
    f64 (G, and S as one operator) within 1e-13 normwise; one launch a
    product (slots and tail), no K3 / K1; two launches bit-identical."""
    device, hier, (G, S) = cuda_ell
    fine = hier.levels[-1]
    A = {"K": fine.op, "P": fine.P, "R": fine.R, "G": G, "S": S}[which]
    assert isinstance(A, spmv.EllMatrix)
    f64 = A.values.dtype == torch.float64
    rng = np.random.default_rng(6)
    x = torch.as_tensor(rng.standard_normal(A.shape[1]), device=device,
                        dtype=torch.float64 if f64 else torch.float32)
    spmv.LAUNCHES.clear()
    y = spmv.sp_matvec(A, x)
    assert spmv.LAUNCHES == {f"ell_spmv_{'f64' if f64 else 'f32'}": 1}
    y_plain = spmv.ell_matvec_plain(A, x)
    if f64:
        assert float(torch.linalg.norm(y - y_plain) / torch.linalg.norm(y_plain)) <= 1e-13
    else:
        assert float((y - y_plain).abs().max()) <= 2e-6 * float(y_plain.abs().max())
    assert torch.equal(y, spmv.sp_matvec(A, x))


def test_ell_solve_runs_through_k6(cuda_ell):
    device, _, _ = cuda_ell
    spmv.LAUNCHES.clear()
    cfg = TsxTunnelConfig.fast_scale(1, spmv_fmt="ell", corr_mode="gather", residual_fmt="ell")
    r = tsx.solve(cfg, device=device)
    assert spmv.LAUNCHES["ell_spmv_f32"] > 0 and spmv.LAUNCHES["ell_spmv_f64"] > 0
    assert not any(v for k, v in spmv.LAUNCHES.items() if k.endswith("_plain"))
    # every operator of the configuration is ELL: no K3 / K1 launch at all
    assert not any(v for k, v in spmv.LAUNCHES.items() if k.startswith("csr_spmv"))
    assert (r.n_steps, r.n_newton_total, r.n_plastic) == (17, 37, 20)
    assert abs(r.u[40, 0] + 2.166787295662e-03) / 2.166787295662e-03 < 1e-8


@pytest.fixture(scope="module")
def cuda_k7():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    chol.load_kernel()
    return torch.device("cuda")


@pytest.mark.parametrize("n", [128, 200, 908, 2000])
def test_k7_matches_plain(cuda_k7, n):
    """The factor and its inverse blocks within 1e-5 of the plain version,
    the solve within 1e-5 of the plain solve on the same factor and within
    5e-6 of the f64 solve; two launches bit-identical; one launch each."""
    rng = np.random.default_rng(n)
    A = rng.normal(size=(n, n))
    A = (A @ A.T + n * np.eye(n)).astype(np.float32)
    K = torch.as_tensor(A, device=cuda_k7)
    b = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=cuda_k7)
    chol.LAUNCHES.clear()
    L, inv = chol.cholesky_factor(K)
    x = chol.cholesky_solve(L, inv, b, n)
    # the library reports the kernels it launched: one cooperative launch
    assert chol.LAUNCHES == {"cholesky_factor": 1, "cholesky_factorizations": 1,
                             "cholesky_solve": 1}
    Lp, ip = chol.cholesky_factor_plain(K)
    xp = chol.cholesky_solve_plain(L, inv, b, n)
    rel = lambda a, e: float((a - e).abs().max() / e.abs().max())  # noqa: E731
    assert rel(L, Lp) <= 1e-5 and rel(inv, ip) <= 1e-5 and rel(x, xp) <= 1e-5
    assert torch.equal(torch.triu(L, 1), torch.zeros_like(L))
    ref = np.linalg.solve(A.astype(np.float64), b.double().cpu().numpy())
    assert np.abs(x.double().cpu().numpy() - ref).max() / np.abs(ref).max() <= 5e-6
    L2, inv2 = chol.cholesky_factor(K)
    assert torch.equal(L, L2) and torch.equal(inv, inv2)
    assert torch.equal(x, chol.cholesky_solve(L, inv, b, n))


@pytest.mark.parametrize("blocks", [1, 2, 5, 17])
def test_k7_solve_on_a_small_grid(cuda_k7, monkeypatch, blocks):
    """Fewer blocks than steps and tiles (29 at n = 908): a block takes
    several steps and tiles in order, stages three and reads the rest from
    device memory.  Each partial is formed the same way wherever it runs,
    so x is bitwise the full grid's."""
    n = 908
    rng = np.random.default_rng(n)
    A = rng.normal(size=(n, n))
    K = torch.as_tensor((A @ A.T + n * np.eye(n)).astype(np.float32), device=cuda_k7)
    b = torch.as_tensor(rng.normal(size=n).astype(np.float32), device=cuda_k7)
    L, inv = chol.cholesky_factor(K)
    x = chol.cholesky_solve(L, inv, b, n)
    full, scratch = chol._solve_grid(cuda_k7.index or 0, L.shape[0])
    assert full == 8 + 21
    monkeypatch.setattr(chol, "_solve_grid", lambda device, n_pad: (blocks, scratch))
    assert torch.equal(chol.cholesky_solve(L, inv, b, n), x)


def test_k7_refuses_wrong_inputs(cuda_k7):
    K = torch.eye(130, device=cuda_k7)
    L, inv = chol.cholesky_factor(K)
    b = torch.ones(130, device=cuda_k7)
    with pytest.raises(ValueError):
        chol.cholesky_solve_cuda(L.double(), inv, b, 130)
    with pytest.raises(ValueError):
        chol.cholesky_solve_cuda(L, inv[:128], b, 130)
    with pytest.raises(ValueError):
        chol.cholesky_solve_cuda(L, inv, b, 300)
    np.testing.assert_allclose(chol.cholesky_solve(L, inv, b, 130).cpu().numpy(), np.ones(130))


def test_footing_fast_on_the_card(cuda):
    """The dense df32 footing on the card: the f64 run's 16 steps, u within
    1e-9 of it, two runs bit-identical."""
    r64 = footing.solve(FootingConfig(), device=cuda)
    r = footing.solve(FootingConfig.fast(), device=cuda)
    assert r.n_steps == r64.n_steps == 16
    assert np.abs(r.u - r64.u).max() / np.abs(r64.u).max() < 1e-9
    np.testing.assert_allclose(r.zeta_hist[1:17], r64.zeta_hist[1:17], rtol=1e-6)
    r2 = footing.solve(FootingConfig.fast(), device=cuda)
    assert np.array_equal(r.u, r2.u) and r.n_newton_total == r2.n_newton_total


@pytest.fixture(scope="module")
def cuda_tangent():
    """The level-3 tangent-multigrid build on the card (extras: hierarchy,
    tangent tables, host levels), its kernels built."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for load in (spmv.load_kernel, spmv.load_sweep_kernel,
                 spmv.load_transfer_kernel):
        load()
    device = torch.device("cuda")
    extras = {}
    run, _ = footing.build_df32(FootingConfig.fast_scale(3, max_trips=2), device=device,
                                extras=extras)
    return device, run, extras


def test_galerkin_maps_through_the_csr_kernel_match_plain(cuda_tangent):
    """K3's CSR kernel on the rectangular Galerkin maps: within 2e-6 of
    max |plain|, repeatable bit for bit."""
    device, _, extras = cuda_tangent
    vals = extras["hierarchy"].levels[-1].sweep_op.block_values.reshape(-1)
    for M in extras["tangent"].mhat[::-1]:
        y = spmv.csr_matvec(M, vals)
        y_plain = spmv.csr_matvec_plain(M, vals)
        assert float((y - y_plain).abs().max()) <= 2e-6 * float(y_plain.abs().max())
        assert torch.equal(y, spmv.csr_matvec(M, vals))
        vals = y


def test_tangent_multigrid_solve_on_the_card(cuda_tangent):
    """fast_scale(3) for two load trips on the card: every kernel of the
    path, one Galerkin product a coarse level a Newton iteration, no plain
    version, the CPU run's steps and Newton counts, two runs bit-identical;
    a refresh at the elastic tangent leaves the built hierarchy unchanged."""
    from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes
    from fem_elastoplasticity_tpu_torch.solve import multigrid as mgm

    device, run, extras = cuda_tangent
    spmv.LAUNCHES.clear()
    a = run()
    launches = dict(spmv.LAUNCHES)
    b = run()
    assert np.array_equal(a.u, b.u) and a.n_cg_total == b.n_cg_total
    assert not {k: v for k, v in launches.items() if k.endswith("_plain") and v}
    for name in ("csr_spmv_f64", "csr_spmv_f32", "node_block_spmv", "node_transfer",
                 "block_jacobi_sweep"):
        assert launches.get(name, 0) > 0, (name, launches)
    assert launches["csr_spmv_f32"] == 2 * a.n_newton_total  # 3 levels
    assert (a.n_steps, a.newton_trips) == (2, (8, 9))  # the CPU run's (and the JAX run's)
    hier, th = extras["hierarchy"], extras["tangent"]
    before = hier.levels[-1].sweep_op.block_values.clone()
    shear, bulk = lame_moduli(1e7, 0.48)
    d_el = elastic_tangent_lanes(shear, bulk, th.geom.n_int, torch.float32, device)
    ref = mgm.refresh_hierarchy(th, hier, d_el, shear, bulk)
    assert torch.equal(ref.levels[-1].sweep_op.block_values, before)
    assert torch.equal(hier.levels[-1].sweep_op.block_values, before)


@pytest.fixture(scope="module")
def cuda_high_order():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for load in (spmv.load_kernel, spmv.load_sweep_kernel,
                 spmv.load_transfer_kernel):
        load()
    return torch.device("cuda")


@pytest.mark.parametrize("et", ["P2", "P4"])
def test_k1_and_k3_csr_match_plain_on_high_order_g_s(cuda_high_order, et):
    """K1 on the P2 / P4 residual operators (G ~12 / 30 entries a row, S
    with long vertex rows) and K3's CSR kernel on their f32 heads, against
    the plain versions: 1e-13 normwise (f64), 2e-6 of max |plain| (f32)."""
    from fem_elastoplasticity_tpu_torch.ops import assembly_df as adf

    mesh = tsx.tsx_mesh(ElementType[et])
    geom = asm.compute_geometry(torch.as_tensor(mesh.coords, device=cuda_high_order),
                                mesh.elems, volume_element(ElementType[et]))
    G, S = spmv.residual_operators(geom, cuda_high_order)
    gen = torch.Generator(device=cuda_high_order).manual_seed(7)
    for A, A32 in zip((G, S), adf.f32_heads(G, S)):
        x = torch.randn(A.shape[1], generator=gen, dtype=torch.float64, device=cuda_high_order)
        y, y_plain = spmv.csr_spmv_f64_cuda(A, x), spmv.csr_matvec_plain(A, x)
        assert float(torch.linalg.norm(y - y_plain) / torch.linalg.norm(y_plain)) <= 1e-13
        x32 = x.float()
        y32, y32_plain = spmv.csr_spmv_f32_cuda(A32, x32), spmv.csr_matvec_plain(A32, x32)
        assert float((y32 - y32_plain).abs().max()) <= 2e-6 * float(y32_plain.abs().max())
        assert torch.equal(y32, spmv.csr_spmv_f32_cuda(A32, x32))


def test_k3_csr_is_row_serial_on_p4_s32(cuda_high_order):
    """K3's CSR kernel on the f32 head of P4's S (rows of 44 entries on
    average, up to 192 at vertices, cut into row blocks) is bit for bit a
    row-serial PyTorch loop over the padded rows, product and add as
    separate ops: the kernel keeps each row's CSR sum order."""
    from fem_elastoplasticity_tpu_torch.ops import assembly_df as adf

    mesh = tsx.tsx_mesh(ElementType.P4)
    geom = asm.compute_geometry(torch.as_tensor(mesh.coords, device=cuda_high_order),
                                mesh.elems, volume_element(ElementType.P4))
    _, S32 = adf.f32_heads(*spmv.residual_operators(geom, cuda_high_order))
    assert S32.row_blocks.shape[0] - 1 > 1
    rng = np.random.default_rng(21)
    x = torch.as_tensor(rng.standard_normal(S32.shape[1]).astype(np.float32),
                        device=cuda_high_order)
    assert torch.equal(spmv.csr_spmv_f32_cuda(S32, x), spmv.csr_matvec_row_serial(S32, x))


def test_p2_routes_on_the_card(cuda_high_order):
    """P2 cut at zeta 2/17: the p-multigrid route launches K1, K3's CSR
    kernel (two a CG iteration with gs_tangent), K3's transfers and K4 and
    no plain version, and meets the assembled and matrix-free routes."""
    kw = dict(etype=ElementType.P2, zeta_max=2 / 17)
    spmv.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast(solver="ell", **kw), device=cuda_high_order)
    launches = dict(spmv.LAUNCHES)
    assert not any(k.endswith("_plain") for k in launches), launches
    for name in ("csr_spmv_f64", "csr_spmv_f32", "node_transfer", "block_jacobi_sweep"):
        assert launches.get(name, 0) > 0, (name, launches)
    assert launches["csr_spmv_f32"] >= 2 * r.n_cg_total
    for other in (TsxTunnelConfig.fast(solver="cg", **kw),
                  TsxTunnelConfig.fast(solver="cg", assembled_cg=True, **kw)):
        o = tsx.solve(other, device=cuda_high_order)
        assert o.n_steps == r.n_steps == 2
        assert float(np.abs(o.u - r.u).max() / np.abs(r.u).max()) < 1e-9


def test_w_cycle_launches_k3_and_k4_twice_a_level(cuda_high_order):
    """The W-cycle at L2: one cycle is 13 K4 launches (level 2 once, level
    1 twice with its masked residual between) and 6 transfers, no plain
    version; its output within 5e-6 of max |z| of the plain cycle on the
    same hierarchy (the CPU's)."""
    from fem_elastoplasticity_tpu_torch.solve import multigrid as mgm

    extras = {}
    tsx.build_df32(TsxTunnelConfig.fast_scale(2, mg_cycle="w"), device=cuda_high_order,
                   extras=extras)
    hier = extras["hierarchy"]
    n = hier.levels[-1].free.shape[0]
    r = torch.as_tensor(np.random.default_rng(3).standard_normal(n).astype(np.float32),
                        device=cuda_high_order)
    vc = mgm.make_vcycle_ell(hier, cycle="w")
    spmv.LAUNCHES.clear()
    z = vc(r)
    assert spmv.LAUNCHES == {"block_jacobi_sweep": 13, "node_transfer": 6}
    assert torch.equal(z, vc(r))
    cpu = {}
    tsx.build_df32(TsxTunnelConfig.fast_scale(2, mg_cycle="w"), device="cpu", extras=cpu)
    z_plain = mgm.make_vcycle_ell(cpu["hierarchy"], cycle="w")(r.cpu())
    assert float((z.cpu() - z_plain).abs().max()) <= 5e-6 * float(z_plain.abs().max())


def test_slice_options_on_the_card(cuda_high_order):
    """The matrix-free multigrid, the scan CG and the ELL residual heads at
    P2 on the card: mg f64 within 1e-14 of block-Jacobi CG (cut at 2/17);
    scan bitwise the while run; P2 on ELL residual operators through K6 f64
    and f32 only, u within 1e-9 of the CSR route's."""
    kw = dict(refine_levels=1, zeta_max=2 / 17)
    a = tsx.solve(TsxTunnelConfig(solver="mg", **kw), device=cuda_high_order)
    b = tsx.solve(TsxTunnelConfig(solver="cg", **kw), device=cuda_high_order)
    assert a.n_steps == b.n_steps == 2 and float(np.abs(a.u - b.u).max()) <= 1e-14
    runs = [tsx.build_df32(TsxTunnelConfig.fast_scale(1, cg_maxiter=200, cg_structure=s,
                                                      zeta_max=2 / 17),
                           device=cuda_high_order)[0]() for s in ("while", "scan")]
    assert runs[0].n_cg_total == runs[1].n_cg_total and torch.equal(runs[0].u, runs[1].u)
    spmv.LAUNCHES.clear()
    e = tsx.solve(TsxTunnelConfig.fast(etype=ElementType.P2, solver="ell", residual_fmt="ell",
                                       zeta_max=2 / 17), device=cuda_high_order)
    launches = dict(spmv.LAUNCHES)
    assert launches["ell_spmv_f64"] > 0 and launches["ell_spmv_f32"] > 0, launches
    assert not any(k.startswith("csr_spmv") or k.endswith("_plain") for k in launches)
    c = tsx.solve(TsxTunnelConfig.fast(etype=ElementType.P2, solver="ell", gs_tangent=False,
                                       zeta_max=2 / 17), device=cuda_high_order)
    assert e.n_steps == c.n_steps and float(np.abs(e.u - c.u).max() / np.abs(c.u).max()) < 1e-9


def test_footing_quads_on_the_card(cuda_high_order):
    """The footing's Q2 at level 0: the f64 schedule is the reference's
    first steps, and the assembled CG route launches K3's product and K1,
    with residual_fmt "slot" and "rslot" bitwise one route."""
    r = footing.solve(FootingConfig(etype=ElementType.Q2, level=0, bug_compatible_apex=True,
                                    zeta_max=0.005), device=cuda_high_order)
    assert r.n_steps == 5
    np.testing.assert_allclose(r.zeta_hist[1:6], [0.001, 0.002, 0.003, 0.004, 0.005],
                               rtol=0, atol=1e-15)
    us = []
    for fmt in ("slot", "rslot"):
        spmv.LAUNCHES.clear()
        a = footing.solve(FootingConfig.fast(etype=ElementType.Q2, level=0, solver="cg",
                                             assembled_cg=True, residual_fmt=fmt,
                                             zeta_max=0.002), device=cuda_high_order)
        assert spmv.LAUNCHES["node_block_spmv"] > 0 and spmv.LAUNCHES["csr_spmv_f64"] > 0
        assert not any(k.endswith("_plain") for k in spmv.LAUNCHES)
        us.append(a.u)
    assert np.array_equal(*us)
