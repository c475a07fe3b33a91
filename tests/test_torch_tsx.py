"""PyTorch port: the TSX tunnel Newton solve end to end (CPU).

The f64 presets are held to the repository's anchors; the bench preset and
the pure-f32 preset are held to the JAX package's own output, read from the
committed fixtures that `tools/make_port_fixtures.py` writes (a JAX solve
costs ~30 s of compilation, so no test re-runs one).
"""
import pathlib

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.ops import return_map as rm
from fem_elastoplasticity_tpu_torch.ops import spmv
from fem_elastoplasticity_tpu_torch.solve.newton import carry_of
from fem_elastoplasticity_tpu_torch.utils.convert import carry_from_jax, carry_to_jax
from fem_elastoplasticity_tpu_torch.utils.precision import resolve_device

# tiny tensors: extra threads only contend with the other test workers
torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
ANCHOR_U40_F64 = -1.9794499636012143e-03
RAW_REFERENCE_U40 = -1.979449671e-03  # bug_compatible_ep_reset


def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


@pytest.fixture(scope="module")
def jax_bench():
    return dict(np.load(FIXTURES / "tsx_df32_bench.npz"))


@pytest.fixture(scope="module")
def f64_result():
    return tsx.solve(TsxTunnelConfig(), device="cpu")


def test_f64_parity_anchors(f64_result, jax_bench):
    r = f64_result
    assert (r.n_steps, r.n_newton_total, r.n_plastic) == (17, 28, 3)
    assert abs(r.u[40, 0] - ANCHOR_U40_F64) / abs(ANCHOR_U40_F64) < 1e-9
    np.testing.assert_allclose(r.zeta_hist[:17], np.arange(1, 18) / 17.0, rtol=0, atol=1e-12)
    assert abs(r.displ_hist[16] - r.u[40, 0]) < 1e-15
    # the JAX package's native f64 field
    assert rel(r.u, jax_bench["u_f64"]) < 1e-11


def test_f64_ep_reset_matches_raw_reference():
    r = tsx.solve(TsxTunnelConfig(bug_compatible_ep_reset=True), device="cpu")
    assert r.n_steps == 17
    assert abs(r.u[40, 0] - RAW_REFERENCE_U40) / abs(RAW_REFERENCE_U40) < 2e-9
    assert float(np.abs(r.ep).max()) == 0.0


def test_f64_mixed_dense_mode(f64_result):
    r = tsx.solve(TsxTunnelConfig(dense_mode="mixed"), device="cpu")
    assert (r.n_steps, r.n_newton_total) == (17, 28)
    assert rel(r.u, f64_result.u) < 1e-11


def test_bench_preset_matches_jax(jax_bench, f64_result):
    spmv.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast(assembled_cg=True), device="cpu")
    assert spmv.LAUNCHES["csr_spmv_f64_plain"] > 0  # the residual ran on G/S
    counts = (r.n_steps, r.n_newton_total, r.n_plastic)
    assert counts == (17, 28, 3)
    assert counts == tuple(int(jax_bench[k]) for k in ("n_steps", "n_newton_total", "n_plastic"))
    assert abs(r.u[40, 0] - ANCHOR_U40_F64) / abs(ANCHOR_U40_F64) < 1e-9
    assert rel(r.u, jax_bench["u"]) < 1e-11
    assert rel(r.u, f64_result.u) < 1e-11
    assert rel(r.displ_hist, jax_bench["displ_hist"]) < 1e-11
    assert rel(r.ep, jax_bench["ep"]) < 1e-9
    # the JAX df32 stepper records zeta as its f32 head
    np.testing.assert_array_equal(
        r.zeta_hist.astype(np.float32), jax_bench["zeta_hist"].astype(np.float32)
    )


def test_df32_matrix_free_residual(jax_bench):
    """`fast()` without assembled operators: the residual runs matrix-free."""
    spmv.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast(), device="cpu")
    assert sum(spmv.LAUNCHES.values()) == 0
    assert (r.n_steps, r.n_newton_total) == (17, 28)
    assert rel(r.u, jax_bench["u"]) < 1e-11


def test_resume_from_jax_carry(jax_bench):
    """Convert the JAX stepper's carry after 9 load trips and finish there."""
    carry = carry_from_jax(np.load(FIXTURES / "tsx_df32_carry9.npz"), device="cpu")
    assert carry["step"] == 9
    run, _ = tsx.build_df32(TsxTunnelConfig.fast(assembled_cg=True), device="cpu")
    res = run(carry)
    assert (res.n_steps, res.n_newton_total) == (17, 28)
    assert rel(res.u.numpy().reshape(-1, 2), jax_bench["u"]) < 1e-11
    # and the finished carry converts back to the JAX format
    back = carry_to_jax(carry_of(res))
    assert int(back["step"]) == 17 and back["u__hi"].dtype == np.float32


def test_max_trips_chunks_like_one_run():
    cfg = TsxTunnelConfig.fast(assembled_cg=True)
    run, _ = tsx.build_df32(cfg, device="cpu")
    full = run()
    run9, _ = tsx.build_df32(TsxTunnelConfig.fast(assembled_cg=True, max_trips=9), device="cpu")
    part = run9()
    assert part.n_steps == 9
    rest = run(carry_of(part))
    assert (rest.n_steps, rest.n_newton_total) == (full.n_steps, full.n_newton_total)
    assert torch.equal(rest.u, full.u)


def test_reject_path_matches_jax():
    """newton_maxit=2: plastic steps fail to converge, d_zeta halves on each
    reject until it underflows d_zeta_min; the schedule ends short of 1."""
    exp = np.load(FIXTURES / "tsx_f64_maxit2.npz")
    r = tsx.solve(TsxTunnelConfig(newton_maxit=2), device="cpu")
    assert (r.n_steps, r.n_newton_total) == (int(exp["n_steps"]), int(exp["n_newton_total"]))
    assert r.zeta_hist[r.n_steps - 1] < 1.0
    np.testing.assert_allclose(r.zeta_hist, exp["zeta_hist"], rtol=0, atol=1e-15)
    assert rel(r.u, exp["u"]) < 1e-11
    assert rel(r.displ_hist, exp["displ_hist"]) < 1e-11


def test_woodbury_overflow_takes_fresh_factor():
    """cohesion 1.0 yields 124 plastic points, past the Woodbury cap of 64:
    those iterations factor the f32 tangent afresh, and the run still
    matches the native f64 solve (as tests/test_tsx_tunnel.py checks for
    the JAX package)."""
    r64 = tsx.solve(TsxTunnelConfig(cohesion=1.0), device="cpu")
    rf = tsx.solve(TsxTunnelConfig.fast(assembled_cg=True, cohesion=1.0), device="cpu")
    assert rf.n_plastic > 64
    assert float(rf.zeta_hist.max()) >= 1.0
    assert rel(rf.u, r64.u) < 1e-8


def test_fast_f32_preset_matches_jax():
    """Pure-f32 preset: the return map through K2's plain version on the
    CPU, f32 Cholesky with elastic-factor reuse, tolerances at the f32
    criterion floor (the anchor test of tests/test_pallas_return_map.py)."""
    exp = np.load(FIXTURES / "tsx_f32.npz")
    rm.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast_f32(), device="cpu")
    assert rm.LAUNCHES["dp_return_map_plain"] > 0 and rm.LAUNCHES["dp_return_map"] == 0
    print(
        f"tsx f32: port {r.n_steps} steps / {r.n_newton_total} Newton its, "
        f"JAX {int(exp['n_steps'])} / {int(exp['n_newton_total'])}"
    )
    assert r.n_steps == int(exp["n_steps"]) == 17
    assert abs(r.u[40, 0] - ANCHOR_U40_F64) / abs(ANCHOR_U40_F64) < 1e-5
    assert rel(r.u, exp["u"]) < 1e-5
    # zeta is carried in f32: the 17 steps of f32(1/17) end at 1 or above
    np.testing.assert_array_equal(r.zeta_hist[:17], exp["zeta_hist"][:17])


def test_entry_points_run_on_the_card_or_raise():
    """Given no device, an entry point runs on the card; where none is
    visible (as here) it raises rather than run on the host, which is only
    ever chosen by name."""
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsx.solve(TsxTunnelConfig())
    with pytest.raises(RuntimeError, match="CUDA"):
        tsx.build_df32(TsxTunnelConfig.fast_scale(1))
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig

    with pytest.raises(RuntimeError, match="CUDA"):
        footing.solve(FootingConfig())
    assert resolve_device("cpu") == torch.device("cpu")
