"""Kernel K2, the fused Drucker-Prager return map, and its plain version.

Counterpart of `fem_elastoplasticity_tpu/ops/return_map_pallas.py`.  One
pass per integration point computes the trial state, the elastic /
smooth-cone / apex branch, the returned stress, the consistent tangent, the
multiplier lam and, optionally, the updated plastic strain, on
component-major lanes: e3 (3, n), ep (4, n) -> s (4, n), tangent, lam (n,),
ep (4, n).  It is the constitutive update of the native float32 Newton path
(`solve/newton.py`).

* `dp_return_map_plain` is the plain PyTorch version, on the kernel's
  inputs, with the packed tangent ds6 (6, n).  It follows the Pallas kernel's arithmetic line by
  line (`return_map_pallas.py:33-144`) in the input's dtype: every Python
  float of that kernel becomes a constant of the working dtype, as JAX's
  weak typing rounds it, and every division is a true division by a tensor
  (PyTorch on CUDA would otherwise multiply by a rounded reciprocal of a
  Python divisor).
* `dp_return_map_newton` is the Newton loop's entry: (s, D (3, 3, n),
  ind_p = lam > 0, lam, ep) with the initial strain zeta * e0_dir.  On a
  CUDA tensor it is one launch of the hand-written kernel
  `csrc/dp_return_map.cu`, built with `-fmad=false` so that it rounds where
  the plain version rounds; on a CPU tensor the plain version, then
  `unpack_tangent` and `lam > 0`.  The two give the same bits.
* `dp_return_map_fused` has the JAX wrapper's signature and returns ds6:
  `dp_return_map_newton`, then `pack_tangent`.

* `dp_return_map_newton_batched` is the ensemble's entry: B members, each
  with its own eta, c and zeta (a (B, 3) float64 tensor), over shared
  shear and bulk.  On a CUDA tensor one launch of the member-batched
  instance (`dp_return_map_batched_cuda`, the same source), whose member b
  is bitwise a single launch with that member's values; on a CPU tensor
  `dp_return_map_plain_batched`, the plain version with a member axis.

Neither entry falls back from the kernel to the plain version or back.
`LAUNCHES` counts, per process, kernel launches ("dp_return_map",
"dp_return_map_batched") and calls routed to the plain versions
("dp_return_map_plain", "dp_return_map_batched_plain").
"""
from __future__ import annotations

import collections
import ctypes
import functools
import pathlib
from typing import Optional, Tuple

import numpy as np
import torch

KERNEL_SOURCE = pathlib.Path(__file__).parent / "csrc" / "dp_return_map.cu"
KERNEL_FLAGS = ("-fmad=false",)
LAUNCHES: collections.Counter = collections.Counter()

SQRT2 = float(np.sqrt(2.0))
_DTYPES = (torch.float32, torch.float64)


def _material_constants(shear: float, bulk: float) -> Tuple[float, ...]:
    """The material constants, in f64 as the Pallas kernel's Python
    arithmetic forms them; the order of `Consts` in `csrc/dp_return_map.cu`
    (eta and c follow there)."""
    return (
        2.0 * shear,
        bulk,
        shear,
        SQRT2,
        SQRT2 * shear,
        2.0 * SQRT2 * shear * shear,
        4.0 * shear / 3.0 + bulk,
        -2.0 * shear / 3.0 + bulk,
        3.0 * bulk,
    )


_LITERALS = (0.0, 1.0, 2.0, 3.0, 0.5, 2.0 / 3.0, -1.0 / 3.0)


@functools.lru_cache(maxsize=None)
def _constant_tensor(values: Tuple[float, ...], dtype: torch.dtype, device: torch.device):
    return torch.tensor(values, dtype=dtype, device=device)


def dp_return_map_plain(
    e3: torch.Tensor,
    ep_prev: torch.Tensor,
    shear: float,
    bulk: float,
    eta: float,
    c: float,
    e0_dir: Optional[torch.Tensor] = None,
    zeta: float = 1.0,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
):
    """Plain PyTorch K2 on the kernel's inputs: (s, ds6, lam, ep).

    eta and c are rounded to e3's dtype; the initial strain is
    e0_dir * zeta in e0_dir's dtype (None: none).
    """
    dev, dt = e3.device, e3.dtype
    consts = _constant_tensor(_material_constants(shear, bulk) + (float(eta), float(c))
                              + _LITERALS, dt, dev).unbind()
    if e0_dir is None:
        e0 = (consts[11],) * 4
    else:
        e0 = (e0_dir * zeta).reshape(4).to(dt).unbind()
    return _plain_core(e3, ep_prev, consts[:9], consts[9], consts[10], e0, consts[11:],
                       apply_plastic_strain, apex_ep_uses_trial)


def dp_return_map_plain_batched(
    e3: torch.Tensor,
    ep_prev: torch.Tensor,
    shear: float,
    bulk: float,
    params: torch.Tensor,
    e0_dir: Optional[torch.Tensor] = None,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
):
    """Plain PyTorch version of K2's member-batched instance.

    e3 (B, 3, n) and ep_prev (B, 4, n); params (B, 3) float64 (eta, c,
    zeta) of each member.  Returns (s (B, 4, n), ds6 (B, 6, n), lam (B, n),
    ep (B, 4, n)): member b's bits are `dp_return_map_plain` with that
    member's eta, c and zeta, which are rounded to e3's dtype as the single
    version rounds its Python floats."""
    dev, dt = e3.device, e3.dtype
    consts = _constant_tensor(_material_constants(shear, bulk) + _LITERALS, dt, dev).unbind()
    p = params.to(device=dev, dtype=torch.float64).to(dt)
    eta, c, zeta = p[:, 0:1], p[:, 1:2], p[:, 2:3]
    if e0_dir is None:
        e0 = (consts[9],) * 4
    else:
        e0 = (e0_dir.reshape(1, 4) * zeta.to(e0_dir.dtype)).to(dt).split(1, dim=1)
    return _plain_core(e3, ep_prev, consts[:9], eta, c, e0, consts[9:],
                       apply_plastic_strain, apex_ep_uses_trial)


def _plain_core(e3, ep_prev, shared, eta, c, e0, literals, apply_plastic_strain,
                apex_ep_uses_trial):
    """The body of the plain versions, on (..., k, n) components: `shared`
    the 0-d constants of `_material_constants`, `literals` those of
    `_LITERALS`, eta and c 0-d (one material) or (B, 1) (a member each),
    e0 four initial-strain components shaped like eta."""
    two_g, bulk_t, shear_t, sqrt2, sg, ca_k, e_diag, e_off, three_bulk = shared
    zero, one, two, three, half, two_thirds, minus_third = literals
    e0_0, e0_1, e0_2, e0_3 = e0
    row = lambda t, k: t[..., k, :]  # noqa: E731

    e4_0 = row(e3, 0) + e0_0
    e4_1 = row(e3, 1) + e0_1
    e4_2 = row(e3, 2) + e0_2
    e4_3 = e0_3 + torch.zeros_like(e4_0)

    et0 = e4_0 - row(ep_prev, 0)
    et1 = e4_1 - row(ep_prev, 1)
    et2 = e4_2 - row(ep_prev, 2)
    et3 = e4_3 - row(ep_prev, 3)

    tr = et0 + et1 + et3
    dev0 = et0 - tr / three
    dev1 = et1 - tr / three
    dev2 = et2 / two
    dev3 = et3 - tr / three

    ktr = bulk_t * tr
    st0 = two_g * dev0 + ktr
    st1 = two_g * dev1 + ktr
    st2 = two_g * dev2
    st3 = two_g * dev3 + ktr

    norm_sq = torch.clamp(et0 * dev0 + et1 * dev1 + et2 * dev2 + et3 * dev3, min=0.0)
    norm_e = torch.sqrt(norm_sq)
    rho_tr = two_g * norm_e
    p_tr = bulk_t * tr

    denom_a = bulk_t * eta * eta
    denom_s = shear_t + denom_a
    crit1 = rho_tr / sqrt2 + eta * p_tr - c
    crit2 = eta * p_tr - denom_a * rho_tr / sg - c

    ind_p = crit1 > 0.0
    ind_s = ind_p & (crit2 <= 0.0)
    ind_a = ind_p & (crit2 > 0.0)

    lam_s = crit1 / denom_s
    lam_a = (eta * p_tr - c) / denom_a
    lam = torch.where(ind_s, lam_s, torch.where(ind_a, lam_a, zero))

    pos = norm_e > 0.0
    inv_norm = torch.where(pos, one / torch.where(pos, norm_e, one), zero)
    n0 = dev0 * inv_norm
    n1 = dev1 * inv_norm
    n2 = dev2 * inv_norm
    n3 = dev3 * inv_norm

    ke = bulk_t * eta
    m0 = sg * n0 + ke
    m1 = sg * n1 + ke
    m2 = sg * n2
    m3 = sg * n3 + ke

    apex = (c / eta) + zero
    s = torch.stack([
        torch.where(ind_s, st0 - lam_s * m0, torch.where(ind_a, apex, st0)),
        torch.where(ind_s, st1 - lam_s * m1, torch.where(ind_a, apex, st1)),
        torch.where(ind_s, st2 - lam_s * m2, torch.where(ind_a, zero, st2)),
        torch.where(ind_s, st3 - lam_s * m3, torch.where(ind_a, apex, st3)),
    ], dim=-2)

    safe_rho = torch.where(rho_tr > 0.0, rho_tr, one)
    ca = torch.where(ind_s, ca_k * lam_s / safe_rho, zero)
    ms = torch.where(ind_s, one / denom_s, zero)
    not_a = torch.where(ind_a, zero, one)
    ds6 = torch.stack([
        (e_diag - ca * (two_thirds - n0 * n0) - m0 * m0 * ms) * not_a,
        (e_diag - ca * (two_thirds - n1 * n1) - m1 * m1 * ms) * not_a,
        (shear_t - ca * (half - n2 * n2) - m2 * m2 * ms) * not_a,
        (e_off - ca * (minus_third - n0 * n1) - m0 * m1 * ms) * not_a,
        (ca * n0 * n2 - m0 * m2 * ms) * not_a,
        (ca * n1 * n2 - m1 * m2 * ms) * not_a,
    ], dim=-2)

    if apply_plastic_strain:
        eta_third = eta / three
        f = (n0 / sqrt2 + eta_third, n1 / sqrt2 + eta_third,
             two * (n2 / sqrt2), n3 / sqrt2 + eta_third)
        ab = (et0, et1, et2, et3) if apex_ep_uses_trial else (e4_0, e4_1, e4_2, e4_3)
        shift = c / (three_bulk * eta)
        ep = torch.stack([
            torch.where(ind_s, row(ep_prev, k) + lam_s * f[k],
                        torch.where(ind_a, ab[k] - shift if k != 2 else ab[k], row(ep_prev, k)))
            for k in range(4)
        ], dim=-2)
    else:
        ep = ep_prev.clone()
    return s, ds6, lam, ep


def unpack_tangent(ds6: torch.Tensor) -> torch.Tensor:
    """(..., 6, n) unique entries [d00, d11, d22, d01, d02, d12] ->
    (..., 3, 3, n)."""
    d00, d11, d22, d01, d02, d12 = ds6.unbind(-2)
    return torch.stack([
        torch.stack([d00, d01, d02], dim=-2),
        torch.stack([d01, d11, d12], dim=-2),
        torch.stack([d02, d12, d22], dim=-2),
    ], dim=-3)


def pack_tangent(D: torch.Tensor) -> torch.Tensor:
    """(3, 3, n) -> (6, n) unique entries, `unpack_tangent`'s inverse."""
    return torch.stack([D[0, 0], D[1, 1], D[2, 2], D[0, 1], D[0, 2], D[1, 2]])


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import build_library

    lib = build_library(KERNEL_SOURCE, "dp_return_map", KERNEL_FLAGS)
    for fn in (lib.dp_return_map_f32, lib.dp_return_map_f64):
        fn.argtypes = ([ctypes.c_longlong] + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2
                       + [ctypes.c_double] + [ctypes.c_void_p] * 5)
        fn.restype = ctypes.c_int
    for fn in (lib.dp_return_map_batched_f32, lib.dp_return_map_batched_f64):
        fn.argtypes = ([ctypes.c_longlong] * 2 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 11)
        fn.restype = ctypes.c_int
    return lib


def load_kernel() -> None:
    """Build (first use) and load K2; raises if the build fails."""
    _library()


@functools.lru_cache(maxsize=None)
def _kernel_constants(shear: float, bulk: float, eta: float, c: float):
    """The kernel's `Consts` as a ctypes array of doubles, built once per
    material: `_material_constants`, then eta and c."""
    values = _material_constants(shear, bulk) + (eta, c)
    return (ctypes.c_double * len(values))(*values)


def dp_return_map_cuda(
    e3: torch.Tensor,
    ep_prev: torch.Tensor,
    shear: float,
    bulk: float,
    eta: float,
    c: float,
    e0_dir: Optional[torch.Tensor] = None,
    zeta: float = 1.0,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
):
    """Launch K2 on e3's device and PyTorch's current stream; no sync.

    e3 (3, n), ep_prev (4, n) and e0_dir (4,) (or None: no initial strain)
    contiguous, of one dtype, on one card; the initial strain is
    zeta * e0_dir, rounded once.  Returns views of one allocation:
    (s (4, n), D (3, 3, n), ind_p (n,) bool, lam (n,), ep (4, n))."""
    if not e3.is_cuda:
        raise ValueError(f"dp_return_map_cuda needs a CUDA tensor; got one on {e3.device}")
    dt = e3.dtype
    if dt not in _DTYPES:
        raise ValueError(f"dp_return_map: dtype {dt} is not float32 or float64")
    n = e3.shape[-1]
    inputs = [("e3", e3, (3, n)), ("ep_prev", ep_prev, (4, n))]
    if e0_dir is not None:
        inputs.append(("e0_dir", e0_dir, (4,)))
    for name, t, shape in inputs:
        if t.device != e3.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"dp_return_map: {name} must be a contiguous {dt} tensor on "
                f"{e3.device}; got {t.dtype} on {t.device}"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"dp_return_map: {name} has shape {tuple(t.shape)}, not {shape}")
    lib = _library()
    fn = lib.dp_return_map_f32 if dt == torch.float32 else lib.dp_return_map_f64
    size = e3.element_size()
    buf = torch.empty(18 * n * size + n, dtype=torch.uint8, device=e3.device)
    vals = buf[:18 * n * size].view(dt)
    ind_p = buf[18 * n * size:].view(torch.bool)
    if n:
        err = fn(
            n, int(apply_plastic_strain), int(apex_ep_uses_trial),
            _kernel_constants(shear, bulk, eta, c),
            None if e0_dir is None else e0_dir.data_ptr(), zeta, e3.data_ptr(),
            ep_prev.data_ptr(), vals.data_ptr(), ind_p.data_ptr(),
            torch.cuda.current_stream(e3.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"dp_return_map launch failed: cudaError_t {err}")
        LAUNCHES["dp_return_map"] += 1
    s, D, lam, ep = vals.split((4 * n, 9 * n, n, 4 * n))
    return s.view(4, n), D.view(3, 3, n), ind_p, lam, ep.view(4, n)


@functools.lru_cache(maxsize=None)
def _shared_constants(shear: float, bulk: float):
    """The batched instance's shared constants as a ctypes array of doubles:
    `_material_constants` (eta and c come from the device params)."""
    values = _material_constants(shear, bulk)
    return (ctypes.c_double * len(values))(*values)


def dp_return_map_batched_cuda(
    e3: torch.Tensor,
    ep_prev: torch.Tensor,
    shear: float,
    bulk: float,
    params: torch.Tensor,
    e0_dir: Optional[torch.Tensor] = None,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
):
    """Launch K2's member-batched instance on e3's device and PyTorch's
    current stream; no sync.

    e3 (B, 3, n) and ep_prev (B, 4, n) contiguous, of one dtype; params
    (B, 3) contiguous float64 on the same card, each member's (eta, c,
    zeta); e0_dir (4,) in e3's dtype, or None.  One launch covers B x n
    points.  Returns (s (B, 4, n), D (B, 3, 3, n), ind_p (B, n) bool, lam
    (B, n), ep (B, 4, n)); member b's values are bitwise a single K2 launch
    with its eta, c and zeta."""
    if not e3.is_cuda:
        raise ValueError(f"dp_return_map_batched_cuda needs a CUDA tensor; got one on {e3.device}")
    dt = e3.dtype
    if dt not in _DTYPES:
        raise ValueError(f"dp_return_map_batched: dtype {dt} is not float32 or float64")
    if e3.dim() != 3:
        raise ValueError(f"dp_return_map_batched: e3 has shape {tuple(e3.shape)}, not (B, 3, n)")
    n_b, n = e3.shape[0], e3.shape[-1]
    inputs = [("e3", e3, (n_b, 3, n), dt), ("ep_prev", ep_prev, (n_b, 4, n), dt),
              ("params", params, (n_b, 3), torch.float64)]
    if e0_dir is not None:
        inputs.append(("e0_dir", e0_dir, (4,), dt))
    for name, t, shape, want in inputs:
        if t.device != e3.device or t.dtype != want or not t.is_contiguous():
            raise ValueError(
                f"dp_return_map_batched: {name} must be a contiguous {want} tensor on "
                f"{e3.device}; got {t.dtype} on {t.device}"
            )
        if tuple(t.shape) != shape:
            raise ValueError(
                f"dp_return_map_batched: {name} has shape {tuple(t.shape)}, not {shape}")
    lib = _library()
    fn = lib.dp_return_map_batched_f32 if dt == torch.float32 else lib.dp_return_map_batched_f64
    s = torch.empty((n_b, 4, n), dtype=dt, device=e3.device)
    D = torch.empty((n_b, 3, 3, n), dtype=dt, device=e3.device)
    lam = torch.empty((n_b, n), dtype=dt, device=e3.device)
    ep = torch.empty((n_b, 4, n), dtype=dt, device=e3.device)
    ind_p = torch.empty((n_b, n), dtype=torch.bool, device=e3.device)
    if n_b and n:
        err = fn(
            n_b, n, int(apply_plastic_strain), int(apex_ep_uses_trial),
            _shared_constants(shear, bulk), params.data_ptr(),
            None if e0_dir is None else e0_dir.data_ptr(), e3.data_ptr(), ep_prev.data_ptr(),
            s.data_ptr(), D.data_ptr(), lam.data_ptr(), ep.data_ptr(), ind_p.data_ptr(),
            torch.cuda.current_stream(e3.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"dp_return_map_batched launch failed: cudaError_t {err}")
        LAUNCHES["dp_return_map_batched"] += 1
    return s, D, ind_p, lam, ep


def _plain_route(e3: torch.Tensor, name: str) -> None:
    if e3.device.type != "cpu":
        raise ValueError(f"{name}: no route for device {e3.device}")
    LAUNCHES["dp_return_map_plain"] += 1


def dp_return_map_newton(
    e3: torch.Tensor,
    ep_prev: torch.Tensor,
    shear: float,
    bulk: float,
    eta: float,
    c: float,
    e0_dir: Optional[torch.Tensor] = None,
    zeta: float = 1.0,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
):
    """The Newton loop's return map: (s (4, n), D (3, 3, n), ind_p (n,)
    bool = lam > 0, lam (n,), ep (4, n)), the initial strain zeta * e0_dir
    (None: none).  One K2 launch on a CUDA tensor; on a CPU tensor the
    plain version, `unpack_tangent` and `lam > 0`, with the same bits."""
    if e3.is_cuda:
        return dp_return_map_cuda(
            e3.contiguous(), ep_prev.contiguous(), shear, bulk, eta, c, e0_dir, zeta,
            apply_plastic_strain, apex_ep_uses_trial,
        )
    _plain_route(e3, "dp_return_map_newton")
    s, ds6, lam, ep = dp_return_map_plain(
        e3, ep_prev, shear, bulk, eta, c, e0_dir, zeta, apply_plastic_strain,
        apex_ep_uses_trial,
    )
    return s, unpack_tangent(ds6), lam > 0.0, lam, ep


def dp_return_map_fused(
    e3: torch.Tensor,
    ep_prev: torch.Tensor,
    shear: float,
    bulk: float,
    eta: float,
    c: float,
    e0: Optional[torch.Tensor] = None,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
):
    """Fused constitutive update (`return_map_pallas.py:160`).

    e3 (3, n) strain, ep_prev (4, n) plastic strain, e0 (4,) initial strain
    (already zeta-scaled) or None; eta and c are rounded to e3's dtype.
    Returns (s (4, n), ds6 (6, n), lam (n,), ep (4, n)):
    `dp_return_map_newton`, then `pack_tangent`.
    """
    if e0 is not None:
        e0 = e0.reshape(4).to(e3.dtype).contiguous()
    s, D, _, lam, ep = dp_return_map_newton(
        e3, ep_prev, shear, bulk, eta, c, e0, 1.0, apply_plastic_strain, apex_ep_uses_trial,
    )
    return s, pack_tangent(D), lam, ep


def dp_return_map_newton_batched(
    e3: torch.Tensor,
    ep_prev: torch.Tensor,
    shear: float,
    bulk: float,
    params: torch.Tensor,
    e0_dir: Optional[torch.Tensor] = None,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
):
    """The ensemble Newton loop's return map over B members: (s (B, 4, n),
    D (B, 3, 3, n), ind_p (B, n) = lam > 0, lam (B, n), ep (B, 4, n)),
    params (B, 3) float64 each member's (eta, c, zeta).  One launch of K2's
    member-batched instance on a CUDA tensor; on a CPU tensor its plain
    version, `unpack_tangent` and `lam > 0`, with the same bits."""
    if e3.is_cuda:
        return dp_return_map_batched_cuda(
            e3.contiguous(), ep_prev.contiguous(), shear, bulk, params.contiguous(), e0_dir,
            apply_plastic_strain, apex_ep_uses_trial,
        )
    if e3.device.type != "cpu":
        raise ValueError(f"dp_return_map_newton_batched: no route for device {e3.device}")
    LAUNCHES["dp_return_map_batched_plain"] += 1
    s, ds6, lam, ep = dp_return_map_plain_batched(
        e3, ep_prev, shear, bulk, params, e0_dir, apply_plastic_strain, apex_ep_uses_trial,
    )
    return s, unpack_tangent(ds6), lam > 0.0, lam, ep
