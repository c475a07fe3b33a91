"""Plane-strain elasticity and Drucker-Prager elastoplasticity on tensors.

Port of `fem_elastoplasticity_tpu/models/materials.py` (lane-major form).
The return map is branchless (`torch.where` over the elastic, smooth-cone
and apex partitions), one elementwise pass over every integration point.

State conventions (as in the JAX package):
  * strain arrives in 3-component Voigt form [e11, e22, 2*e12],
  * stress and plastic strain carry the plane-strain 4th component
    [s11, s22, s12, s33],
  * the consistent tangent (3, 3, n) acts on the 3-component strain.

Both reference defects fixed by the JAX package stay fixed: the apex
multiplier is the scalar (eta*p_tr - c)/denom_a, and the apex plastic strain
comes from the total strain unless `apex_ep_uses_trial=True`.

The df32 preset uses this same f64 return map in place of the JAX package's
double-float `materials_df.dp_return_map_lanes_df`.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

SQRT2 = float(np.sqrt(2.0))


def lame_moduli(young: float, poisson: float):
    """(shear G, bulk K) from (E, nu)."""
    shear = young / (2.0 * (1.0 + poisson))
    bulk = young / (3.0 * (1.0 - 2.0 * poisson))
    return shear, bulk


def drucker_prager_fit(cohesion, friction_angle):
    """Plane-strain DP fit to Mohr-Coulomb: (eta, c), Python floats from
    scalars, float64 arrays from arrays (a material ensemble's grid)."""
    t = np.tan(friction_angle)
    den = np.sqrt(9.0 + 12.0 * t * t)
    eta, c = 3.0 * t / den, 3.0 * cohesion / den
    if np.ndim(eta) == 0 and np.ndim(c) == 0:
        return float(eta), float(c)
    return np.asarray(eta, np.float64), np.asarray(c, np.float64)


def elastic_tangent_lanes(shear, bulk, n: int, dtype=torch.float64, device=None):
    """Elastic tangent broadcast lane-major to (3, 3, n)."""
    d = torch.full((n,), 4.0 * shear / 3.0 + bulk, dtype=dtype, device=device)
    o = torch.full((n,), -2.0 * shear / 3.0 + bulk, dtype=dtype, device=device)
    g = torch.full((n,), shear, dtype=dtype, device=device)
    z = torch.zeros((n,), dtype=dtype, device=device)
    return torch.stack(
        [torch.stack([d, o, z]), torch.stack([o, d, z]), torch.stack([z, z, g])]
    )


def lanes(value, like: torch.Tensor) -> torch.Tensor:
    """A Python float as a tensor shaped like `like`; a (B, 1) per-member
    tensor broadcast to it."""
    if torch.is_tensor(value):
        return value.expand_as(like)
    return torch.full_like(like, value)


def dp_return_map_lanes(
    e3: torch.Tensor,
    ep_prev: torch.Tensor,
    shear: float,
    bulk: float,
    eta,
    c,
    e0: Optional[torch.Tensor] = None,
    apply_plastic_strain: bool = False,
    apex_ep_uses_trial: bool = False,
):
    """Lane-major Drucker-Prager return map.

    e3 (3, n), ep_prev (4, n), e0 optional (4,) or (4, n).  Returns
    s (4, n), ds (3, 3, n), ind_p (n,), lam (n,), ep (4, n); ep equals
    ep_prev unless `apply_plastic_strain`.

    Member-batched: e3 (B, 3, n), ep_prev (B, 4, n), eta and c (B, 1)
    tensors of e3's dtype, e0 (B, 4, 1) or (B, 4, n); every result gains the
    leading member axis.  The arithmetic is the same, in the same order, so
    on the CPU member b's bits are those of a call with its eta and c as
    Python floats.
    """
    row = lambda t, k: t[..., k, :]  # noqa: E731
    zero = torch.zeros_like(row(e3, 0))
    e4 = torch.stack([row(e3, 0), row(e3, 1), row(e3, 2), zero], dim=-2)
    if e0 is not None:
        e4 = e4 + (e0[:, None] if e0.ndim == 1 else e0)

    et = e4 - ep_prev
    tr = row(et, 0) + row(et, 1) + row(et, 3)
    dev0 = row(et, 0) - tr / 3.0
    dev1 = row(et, 1) - tr / 3.0
    dev2 = row(et, 2) / 2.0
    dev3_ = row(et, 3) - tr / 3.0

    two_g = 2.0 * shear
    ktr = bulk * tr
    s_tr = torch.stack(
        [two_g * dev0 + ktr, two_g * dev1 + ktr, two_g * dev2, two_g * dev3_ + ktr], dim=-2
    )

    norm_sq = torch.clamp(
        row(et, 0) * dev0 + row(et, 1) * dev1 + row(et, 2) * dev2 + row(et, 3) * dev3_,
        min=0.0,
    )
    norm_e = torch.sqrt(norm_sq)
    rho_tr = two_g * norm_e
    p_tr = bulk * tr

    denom_a = bulk * eta * eta
    denom_s = shear + denom_a
    crit1 = rho_tr / SQRT2 + eta * p_tr - c
    crit2 = eta * p_tr - denom_a * rho_tr / (shear * SQRT2) - c

    ind_p = crit1 > 0.0
    ind_s = ind_p & (crit2 <= 0.0)
    ind_a = ind_p & (crit2 > 0.0)

    lam_s = crit1 / denom_s
    lam_a = (eta * p_tr - c) / denom_a
    lam = torch.where(ind_s, lam_s, torch.where(ind_a, lam_a, zero))

    pos = norm_e > 0.0
    inv_norm = torch.where(pos, 1.0 / torch.where(pos, norm_e, torch.ones_like(norm_e)), zero)
    n0 = dev0 * inv_norm
    n1 = dev1 * inv_norm
    n2 = dev2 * inv_norm
    n3 = dev3_ * inv_norm

    sg = SQRT2 * shear
    ke = bulk * eta
    m0 = sg * n0 + ke
    m1 = sg * n1 + ke
    m2 = sg * n2
    m3 = sg * n3 + ke

    s_apex_d = lanes(c / eta, zero)
    s_out = []
    for k, (mk, apex_k) in enumerate([(m0, s_apex_d), (m1, s_apex_d), (m2, zero), (m3, s_apex_d)]):
        s_out.append(
            torch.where(ind_s, row(s_tr, k) - lam_s * mk, torch.where(ind_a, apex_k, row(s_tr, k)))
        )
    s = torch.stack(s_out, dim=-2)

    # consistent tangent: ds_el - coef*(Dev3 - nn^T) - mm^T/denom_s, entry-wise
    safe_rho = torch.where(rho_tr > 0.0, rho_tr, torch.ones_like(rho_tr))
    ca = torch.where(ind_s, 2.0 * SQRT2 * shear * shear * lam_s / safe_rho, zero)
    ms = torch.where(ind_s, lanes(1.0 / denom_s, zero), zero)
    e_diag = 4.0 * shear / 3.0 + bulk
    e_off = -2.0 * shear / 3.0 + bulk
    d00 = e_diag - ca * (2.0 / 3.0 - n0 * n0) - m0 * m0 * ms
    d11 = e_diag - ca * (2.0 / 3.0 - n1 * n1) - m1 * m1 * ms
    d22 = shear - ca * (0.5 - n2 * n2) - m2 * m2 * ms
    d01 = e_off - ca * (-1.0 / 3.0 - n0 * n1) - m0 * m1 * ms
    d02 = ca * n0 * n2 - m0 * m2 * ms
    d12 = ca * n1 * n2 - m1 * m2 * ms
    not_a = torch.where(ind_a, zero, torch.ones_like(zero))
    d00, d11, d22 = d00 * not_a, d11 * not_a, d22 * not_a
    d01, d02, d12 = d01 * not_a, d02 * not_a, d12 * not_a
    ds = torch.stack(
        [
            torch.stack([d00, d01, d02], dim=-2),
            torch.stack([d01, d11, d12], dim=-2),
            torch.stack([d02, d12, d22], dim=-2),
        ],
        dim=-3,
    )

    if apply_plastic_strain:
        # ep += lam_s * [1,1,2,1] o (n_hat/sqrt2 + eta/3 * iota) on smooth
        flow = torch.stack(
            [
                n0 / SQRT2 + eta / 3.0,
                n1 / SQRT2 + eta / 3.0,
                2.0 * (n2 / SQRT2),
                n3 / SQRT2 + eta / 3.0,
            ],
            dim=-2,
        )
        ep_smooth = ep_prev + lam_s.unsqueeze(-2) * flow
        apex_base = et if apex_ep_uses_trial else e4
        apex_shift = c / (3.0 * bulk * eta)
        ep_apex = torch.stack(
            [
                row(apex_base, 0) - apex_shift,
                row(apex_base, 1) - apex_shift,
                row(apex_base, 2),
                row(apex_base, 3) - apex_shift,
            ],
            dim=-2,
        )
        ep = torch.where(
            ind_s.unsqueeze(-2), ep_smooth, torch.where(ind_a.unsqueeze(-2), ep_apex, ep_prev)
        )
    else:
        ep = ep_prev

    return s, ds, ind_p, lam, ep
