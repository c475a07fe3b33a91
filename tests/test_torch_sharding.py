"""PyTorch port: multi-device runs (`parallel/sharding.py`) on CPU ranks.

Every run here spawns 2 or 3 ranks over gloo on the CPU (`device="cpu"`),
the counterpart of the JAX package's virtual CPU mesh
(`tests/test_parallel.py`).  The element-sharded solves are held to the
port's single-device solves and, at three ranks, to the JAX package's own
sharded run (`tests/fixtures/torch_port/tsx_sharded_cg_n3_z3.npz`, written
by `tools/make_port_fixtures.py`); the row-sharded ones bit for bit to the
single-device builds.  The row slicing and K4's split-z plain version are
checked without spawning.  The references run single-threaded, as the
ranks do: a multi-threaded CPU reduction may sum in another order.
"""
import functools
import pathlib

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.models.materials import lame_moduli
from fem_elastoplasticity_tpu_torch.ops import spmv
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element
from fem_elastoplasticity_tpu_torch.parallel import ensemble as ens
from fem_elastoplasticity_tpu_torch.parallel import sharding
from fem_elastoplasticity_tpu_torch.solve import multigrid as mgm

torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
CPU = torch.device("cpu")
Z3 = 3 / 17  # three elastic load steps
FOOTING_CUT = FootingConfig.fast(solver="cg", level=2, tangent_mg=True, zeta_max=0.004,
                                 max_trips=1)


@functools.lru_cache(maxsize=None)
def single_cg():
    return tsx.solve(TsxTunnelConfig(solver="cg", zeta_max=Z3), device=CPU)


@functools.lru_cache(maxsize=None)
def sharded_cg(n: int):
    return tsx.solve_sharded(TsxTunnelConfig(zeta_max=Z3), n, device=CPU)


@pytest.mark.parametrize("n", [2, 3])
def test_solve_sharded_matches_single_device_cg(n):
    r, r1 = sharded_cg(n), single_cg()
    assert (r.n_steps, r.n_newton_total) == (r1.n_steps, r1.n_newton_total) == (3, 3)
    np.testing.assert_allclose(r.u, r1.u, rtol=0, atol=1e-14)
    np.testing.assert_array_equal(r.zeta_hist, r1.zeta_hist)
    assert r.ep.shape == r1.ep.shape and r.n_plastic == r1.n_plastic


def test_padding_inert_across_rank_counts():
    # 887 elements: every rank count pads (JAX test_padding_inert)
    np.testing.assert_allclose(sharded_cg(3).u, sharded_cg(2).u, rtol=0, atol=1e-14)


def test_solve_sharded_matches_jax_sharded_run():
    ref = np.load(FIXTURES / "tsx_sharded_cg_n3_z3.npz")
    r = sharded_cg(3)
    assert (r.n_steps, r.n_newton_total) == (int(ref["n_steps"]), int(ref["n_newton_total"]))
    np.testing.assert_allclose(r.u, ref["u"], rtol=0, atol=1e-14)
    # the counts of these elastic steps run on rounding residuals: printed
    print(f"CG: port {r.n_cg_total}, JAX {int(ref['n_cg_total'])}")


def test_solve_sharded_df32_matches_single_df32():
    cfg = TsxTunnelConfig.fast(solver="cg", zeta_max=Z3)
    r1 = tsx.solve(cfg, device=CPU)
    r = tsx.solve_sharded_df32(cfg, 2, device=CPU)
    assert (r.n_steps, r.n_newton_total) == (r1.n_steps, r1.n_newton_total)
    np.testing.assert_allclose(r.u, r1.u, rtol=0, atol=1e-12 * np.abs(r1.u).max())


@pytest.mark.parametrize("n", [2, 3])
def test_solve_sharded_scale_is_bitwise_single_device(n):
    cfg = TsxTunnelConfig.fast_scale(1, zeta_max=Z3)
    r1 = _single_scale(cfg)
    r = tsx.solve_sharded_scale(cfg, n, device=CPU)
    assert (r.n_steps, r.n_newton_total, r.n_cg_total) == (
        r1.n_steps, r1.n_newton_total, r1.n_cg_total)
    np.testing.assert_array_equal(r.zeta_hist, r1.zeta_hist)
    np.testing.assert_array_equal(r.u, r1.u)
    np.testing.assert_array_equal(r.ep, r1.ep)


@functools.lru_cache(maxsize=None)
def _single_scale(cfg):
    return tsx.solve(cfg, device=CPU)


def test_footing_sharded_tangent_mg_is_bitwise_single_device():
    run, _ = footing.build_df32(FOOTING_CUT, device=CPU)
    r1 = run()
    r = footing.solve_sharded(FOOTING_CUT, 2, device=CPU)
    assert (r.n_steps, r.newton_trips, r.n_cg_total) == (
        r1.n_steps, r1.newton_trips, r1.n_cg_total)
    np.testing.assert_array_equal(r.u, r1.u)
    np.testing.assert_array_equal(r.zeta_hist, r1.zeta_hist)


def test_member_sharded_ensemble():
    # 4 members over 3 ranks: two copies of member 0 pad it to 6, trimmed
    eta, c = ens.material_grid(np.array([15.0, 18.7]), np.array([45.0, 49.0]) * np.pi / 180)
    e1 = ens.solve_tsx_ensemble_df32(eta, c, device=CPU)
    e3 = ens.solve_tsx_ensemble_df32(eta, c, shard_devices=3, device=CPU)
    assert e3.u.shape == e1.u.shape
    np.testing.assert_array_equal(e3.n_steps, e1.n_steps)
    # batched rounding varies with the local batch (JAX states ~1e-16): a
    # member may part only where its criterion sits at newton_tol, named
    forks = ens.member_forks(e3, e1, TsxTunnelConfig.fast().newton_tol)
    print(f"members that part: {forks}")
    assert all(f[5] for f in forks), forks
    held = [b for b in range(4) if b not in {f[0] for f in forks}]
    np.testing.assert_array_equal(e3.n_newton_total[held], e1.n_newton_total[held])
    for b in range(4):
        rel = np.abs(e3.u[b] - e1.u[b]).max() / np.abs(e1.u[b]).max()
        assert rel <= 1e-12, (b, rel)


def test_ranks_import_no_jax():
    info = sharding.spawn(sharding.describe, 2, device=CPU)
    assert [i[:3] for i in info] == [(0, "gloo", "cpu"), (1, "gloo", "cpu")]
    assert not any(i[4] for i in info), info


# the dry run's parts on CPU ranks: the footing's level-3 part takes ~30 s
# on two CPU ranks here and runs on the card (`chip_smoke.py` phase 37)
DRYRUN_CPU_PARTS = ("f64", "df32", "scale")


@functools.lru_cache(maxsize=None)
def _dryrun():
    return sharding.dryrun_multichip(2, device=CPU, parts=DRYRUN_CPU_PARTS)


def test_dryrun_multichip():
    out = _dryrun()
    assert tuple(out) == DRYRUN_CPU_PARTS
    assert out["f64"].n_steps == out["df32"].n_steps == 2
    assert out["scale"].n_steps == 3


def test_sharded_deflation_is_bitwise_single_device():
    """The dry run's third part: `fast_scale(1, zeta_max=3/17,
    cg_deflate=4)` row-sharded over two ranks, its deflation basis and
    ring replicated, bit for bit the single-device build and held to the
    JAX package's run of the same configuration."""
    from test_torch_tsx_options import ELASTIC_CUTS, check_run, config_of, fixture

    cfg = sharding.dryrun_configs()["scale"][1]
    want = fixture("tsx_scale_l1_defl4_z3")
    assert config_of(want) == cfg
    extras = {}
    run, mesh = tsx.build_df32(cfg, device=CPU, extras=extras)
    res = run()
    r1 = tsx._df32_result(res, mesh, extras)
    r = _dryrun()["scale"]
    assert (r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic) == (
        r1.n_steps, r1.n_newton_total, r1.n_cg_total, r1.n_plastic)
    np.testing.assert_array_equal(r.u, r1.u)
    np.testing.assert_array_equal(r.ep, r1.ep)
    np.testing.assert_array_equal(r.zeta_hist, r1.zeta_hist)
    # its schedule is the single build's, whose load trips `check_run` reads;
    # an elastic cut, whose CG count is printed, not held
    assert "tsx_scale_l1_defl4_z3" in ELASTIC_CUTS
    check_run(want, res, r, cfg, hold_cg=False)


# ---------------------------------------------------------------------------
# row slicing, no ranks: every rank's slice built in this process
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _l1_operators():
    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    with np.load(tsx._DATA) as raw:
        hier, _, coarse = mgm.build_hierarchy_ell(
            raw["coords"].astype(np.float64), raw["elems"], 1, tsx._free_of, shear, bulk,
            volume_element(ElementType.P1), device=CPU, pack_bf16=False)
    fine = hier.levels[-1]
    K = coarse["fine_K"]
    geom = tsx._problem(TsxTunnelConfig(refine_levels=1), CPU).geom
    G, S = spmv.residual_operators(geom, CPU)
    return dict(
        K_blocks=fine.sweep_op, P=fine.P, R=fine.R, G_csr=G, S_csr=S,
        K_csr32=spmv.csr_to_device(K, CPU, np.float32),
        K_ell=spmv.build_ell(K, CPU, np.float32), S_ell=spmv.build_ell(
            spmv.build_residual_csr(geom.B.numpy(), geom.weight.numpy(), geom.edofs.numpy(),
                                    geom.n_q, geom.n_nodes)[1], CPU, np.float64,
            max_overflow_frac=0.05),
        aux=fine.aux, free=fine.free)


def _shards(A, n):
    return [spmv.shard_rows(A, sharding.ShardGroup(r, n, CPU, "gloo")) for r in range(n)]


def _joined(parts, ys):
    """The ranks' outputs as `ShardGroup.gather` joins them: each padded to
    the longest with zeros for the transport, cut back, concatenated."""
    counts = parts[0].counts
    longest = max(counts)
    padded = [torch.cat([y, y.new_zeros(longest - y.shape[0])]) for y in ys]
    return torch.cat([p[:c] for p, c in zip(padded, counts)])


@pytest.mark.parametrize("n", [1, 2, 3, 5])
@pytest.mark.parametrize("name", ["K_blocks", "P", "R", "G_csr", "S_csr", "K_csr32", "K_ell",
                                  "S_ell"])
def test_row_slices_are_bitwise_the_whole_product(name, n):
    ops = _l1_operators()
    A = ops[name]
    gen = torch.Generator().manual_seed(7)
    dtype = torch.float64 if name in ("G_csr", "S_csr", "S_ell") else torch.float32
    x = torch.randn(A.shape[1], generator=gen, dtype=torch.float64).to(dtype)
    parts = _shards(A, n)
    assert [p.row0 for p in parts] == list(np.cumsum((0,) + parts[0].counts[:-1]))
    assert sum(parts[0].counts) == A.shape[0]
    if isinstance(A, spmv.EllMatrix):  # cut at slice boundaries: no width changes
        assert all(p.row0 % spmv.ELL_SLICE == 0 for p in parts)
    if name in ("P", "R"):  # the V-cycle's masked transfers, P's with the add
        free = ops["free"] if name == "P" else torch.ones(A.shape[0], dtype=torch.bool)
        z = torch.randn(A.shape[0], generator=gen).to(dtype)
        zz = z if name == "P" else None
        whole = spmv.transfer(A, x, free, zz)
        ys = [spmv.transfer(p.local, x, free[p.row0:p.row0 + p.rows],
                            None if zz is None else zz[p.row0:p.row0 + p.rows])
              for p in parts]
    else:
        whole = spmv.sp_matvec(A, x)
        ys = [spmv.sp_matvec(p.local, x) for p in parts]
    assert torch.equal(_joined(parts, ys), whole)


@pytest.mark.parametrize("n", [2, 3, 5])
@pytest.mark.parametrize("update", [True, False])
def test_k4_split_z_plain_is_bitwise_the_whole_sweep(n, update):
    ops = _l1_operators()
    B, aux = ops["K_blocks"], ops["aux"]
    gen = torch.Generator().manual_seed(11)
    z = torch.randn(B.shape[0], generator=gen)
    r = torch.randn(B.shape[0], generator=gen)
    whole = spmv.node_block_sweep_plain(B, aux, z, r, update)
    K = ops["K_csr32"]
    for p in _shards(B, n):
        rows = slice(p.row0, p.row0 + p.rows)
        aux_l = spmv.SweepAux(*(a[rows] for a in aux))
        assert p.local.node_offset == p.row0 // 2 and p.local.shape[1] == B.shape[1]
        local = spmv.node_block_sweep_plain(p.local, aux_l, z, r[rows], update)
        assert torch.equal(local, whole[rows])
        # the CSR plain version of the same rows takes the same offset
        _, csr_rows = spmv._slice_csr(K, p.row0, p.row0 + p.rows)
        ref = spmv.block_jacobi_sweep_plain(csr_rows, aux_l, z, r[rows], update,
                                            node_offset=p.local.node_offset)
        np.testing.assert_allclose(ref.numpy(), local.numpy(), rtol=0, atol=1e-5)
