"""PyTorch port: kernel K2's plain version against the JAX package (CPU).

The same seeded numpy inputs go through the JAX package's Pallas kernel in
interpret mode (as tests/test_pallas_return_map.py runs it), through its
XLA lanes return map, and through the port's `dp_return_map_plain` /
`dp_return_map_fused`, and through the Newton loop's entry
`dp_return_map_newton`.  The CUDA kernel itself is held to the plain
version on the card (tests/test_torch_gpu.py, chip_smoke.py).
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu.models.materials import (
    dp_return_map_lanes,
    drucker_prager_fit,
    lame_moduli,
)
from fem_elastoplasticity_tpu.ops.return_map_pallas import dp_return_map_pallas
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.ops import return_map as rm
from fem_elastoplasticity_tpu_torch.solve import newton

torch.set_num_threads(1)

G, K = lame_moduli(60000.0, 0.2)
ETA, C = drucker_prager_fit(18.7, 49 * np.pi / 180)
N = 1024


def _sample(seed):
    """The JAX test's distributions: e3 ~ N(0, 2e-3), ep ~ N(0, 2e-4),
    e0 ~ N(0, 1e-3)."""
    rng = np.random.default_rng(seed)
    return rng.normal(0, 2e-3, (3, N)), rng.normal(0, 2e-4, (4, N)), rng.normal(0, 1e-3, 4)


@functools.lru_cache(maxsize=None)
def _jax(dtype, apply, apex, seed):
    e3, ep, e0 = (jnp.asarray(a, dtype) for a in _sample(seed))
    out = dp_return_map_pallas(
        e3, ep, G, K, ETA, C, e0=e0,
        apply_plastic_strain=apply, apex_ep_uses_trial=apex,
    )
    return tuple(np.asarray(a) for a in out)


def _port(dtype, apply, apex, seed):
    e3, ep, e0 = (torch.as_tensor(a, dtype=dtype) for a in _sample(seed))
    return rm.dp_return_map_fused(
        e3, ep, G, K, ETA, C, e0=e0,
        apply_plastic_strain=apply, apex_ep_uses_trial=apex,
    )


def _branches(ds6, lam):
    """(plastic, apex) masks: the apex tangent is exactly zero."""
    lam, ds6 = np.asarray(lam), np.asarray(ds6)
    plastic = lam > 0
    return plastic, plastic & (ds6 == 0).all(axis=0)


@pytest.mark.parametrize("apex", [False, True], ids=["apex_total", "apex_trial"])
@pytest.mark.parametrize("apply", [False, True], ids=["no_ep", "ep"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_plain_matches_pallas_interpret(dtype, apply, apex):
    tdt = torch.float64 if dtype == "float64" else torch.float32
    jdt = jnp.float64 if dtype == "float64" else jnp.float32
    seed = 11
    js, jds6, jlam, jep = _jax(jdt, apply, apex, seed)
    s, ds6, lam, ep = (t.numpy() for t in _port(tdt, apply, apex, seed))
    assert s.dtype == js.dtype and ds6.shape == (6, N) and lam.shape == (N,)

    # all three branches hit, and the port takes the same branch everywhere
    jp, ja = _branches(jds6, jlam)
    pp, pa = _branches(ds6, lam)
    assert 0 < ja.sum() < jp.sum() < N
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pa, ja)

    scale = lambda a: float(np.abs(a).max())  # noqa: E731
    if dtype == "float64":
        # the JAX test's own bounds for the kernel against the lanes path
        tol_s, tol_d = 1e-12, 1e-9
        assert np.abs(lam - jlam).max() < 1e-15
        assert np.abs(ep - jep).max() < 1e-15
    else:
        tol_s = tol_d = 2e-6
        assert np.abs(lam - jlam).max() <= 2e-6 * scale(jlam)
        assert np.abs(ep - jep).max() <= 2e-6 * scale(jep)
    assert np.abs(s - js).max() <= tol_s * scale(js)
    assert np.abs(ds6 - jds6).max() <= tol_d * scale(jds6)
    if not apply:
        np.testing.assert_array_equal(ep, _sample(seed)[1].astype(ep.dtype))


@pytest.mark.parametrize("apex", [False, True], ids=["apex_total", "apex_trial"])
def test_plain_matches_jax_lanes_f64(apex):
    """Against the XLA lanes return map, the JAX package's f64 path."""
    e3, ep, e0 = _sample(3)
    js, jds, jind, jlam, jep = (np.asarray(a) for a in dp_return_map_lanes(
        jnp.asarray(e3), jnp.asarray(ep), G, K, ETA, C, e0=jnp.asarray(e0),
        apply_plastic_strain=True, apex_ep_uses_trial=apex,
    ))
    s, ds6, lam, ep_new = (t.numpy() for t in _port(torch.float64, True, apex, 3))
    np.testing.assert_array_equal(lam > 0, jind)
    assert np.abs(s - js).max() < 1e-12 * np.abs(js).max()
    d = rm.unpack_tangent(torch.as_tensor(ds6)).numpy()
    assert np.abs(d - jds).max() < 1e-9 * np.abs(jds).max()
    assert np.abs(lam - jlam).max() < 1e-15
    assert np.abs(ep_new - jep).max() < 1e-15


def test_unpack_tangent_and_cpu_route_counts():
    ds6 = torch.arange(6 * 5, dtype=torch.float64).reshape(6, 5)
    d = rm.unpack_tangent(ds6)
    assert d.shape == (3, 3, 5)
    torch.testing.assert_close(d, d.transpose(0, 1), rtol=0, atol=0)
    for (i, j), k in {(0, 0): 0, (1, 1): 1, (2, 2): 2, (0, 1): 3, (0, 2): 4, (1, 2): 5}.items():
        assert torch.equal(d[i, j], ds6[k])

    rm.LAUNCHES.clear()
    e3, ep, _ = (torch.as_tensor(a, dtype=torch.float32) for a in _sample(5))
    s, _, lam, _ = rm.dp_return_map_fused(e3, ep, G, K, ETA, C)
    assert dict(rm.LAUNCHES) == {"dp_return_map_plain": 1}
    # e0=None is the zero initial strain
    s0, _, lam0, _ = rm.dp_return_map_fused(e3, ep, G, K, ETA, C, e0=torch.zeros(4))
    assert torch.equal(s, s0) and torch.equal(lam, lam0)
    with pytest.raises(ValueError):
        rm.dp_return_map_cuda(e3, ep, G, K, ETA, C)


@pytest.mark.parametrize("apex", [False, True], ids=["apex_total", "apex_trial"])
@pytest.mark.parametrize("apply", [False, True], ids=["no_ep", "ep"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_newton_entry_is_plain_unpacked(dtype, apply, apex):
    """`dp_return_map_newton` on the CPU: bitwise the plain version with
    e0 = e0_dir * zeta, then `unpack_tangent` and `lam > 0`; and, with
    zeta = 1, the Pallas kernel (interpret mode) with its tangent unpacked,
    at the bounds of `test_plain_matches_pallas_interpret`."""
    tdt = getattr(torch, dtype)
    e3, ep, e0 = (torch.as_tensor(a, dtype=tdt) for a in _sample(11))
    zeta = float(np.float32(7 / 17))
    rm.LAUNCHES.clear()
    s, D, ind_p, lam, ep_new = rm.dp_return_map_newton(
        e3, ep, G, K, ETA, C, e0_dir=e0, zeta=zeta,
        apply_plastic_strain=apply, apex_ep_uses_trial=apex)
    assert dict(rm.LAUNCHES) == {"dp_return_map_plain": 1}
    ps, pds6, plam, pep = rm.dp_return_map_plain(e3, ep, G, K, ETA, C, e0, zeta, apply, apex)
    assert D.shape == (3, 3, N) and ind_p.dtype == torch.bool
    for got, want in ((s, ps), (D, rm.unpack_tangent(pds6)), (ind_p, plam > 0.0),
                      (lam, plam), (ep_new, pep)):
        assert got.dtype == want.dtype and torch.equal(got, want)
    assert torch.equal(rm.pack_tangent(D), pds6)

    js, jds6, jlam, jep = _jax(jnp.float64 if dtype == "float64" else jnp.float32,
                               apply, apex, 11)
    s, D, ind_p, lam, ep_new = (t.numpy() for t in rm.dp_return_map_newton(
        e3, ep, G, K, ETA, C, e0_dir=e0, zeta=1.0,
        apply_plastic_strain=apply, apex_ep_uses_trial=apex))
    np.testing.assert_array_equal(ind_p, jlam > 0)
    jd = rm.unpack_tangent(torch.as_tensor(np.array(jds6))).numpy()
    scale = lambda a: float(np.abs(a).max())  # noqa: E731
    tol_s, tol_d, tol_l = (1e-12, 1e-9, 0.0) if dtype == "float64" else (2e-6, 2e-6, 2e-6)
    assert np.abs(s - js).max() <= tol_s * scale(js)
    assert np.abs(D - jd).max() <= tol_d * scale(jd)
    assert np.abs(lam - jlam).max() <= max(tol_l * scale(jlam), 1e-15)
    assert np.abs(ep_new - jep).max() <= max(tol_l * scale(jep), 1e-15)


def test_f32_newton_route_takes_the_newton_entry(monkeypatch):
    """The native f32 Newton loop calls `dp_return_map_newton` for every
    return map, and on the CPU each call runs the plain version once."""
    calls = []

    def counted(*args, **kw):
        calls.append(kw.get("zeta"))
        return rm.dp_return_map_newton(*args, **kw)

    monkeypatch.setattr(newton, "dp_return_map_newton", counted)
    rm.LAUNCHES.clear()
    r = tsx.solve(TsxTunnelConfig.fast_f32(zeta_max=2 / 17), device="cpu")
    assert r.n_steps == 2 and len(calls) > 2
    assert dict(rm.LAUNCHES) == {"dp_return_map_plain": len(calls)}
    assert all(isinstance(z, float) and z > 0 for z in calls)
