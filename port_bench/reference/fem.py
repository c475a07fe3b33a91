"""Plain NumPy P1 plane-strain elastoplasticity in float64: the yardstick
that decides whether a request the port served is correct.

Nothing here comes from the port.  The formulas are the published ones
(FEM-ElastoPlasticity `pythonFEM.py`, matlabfem arXiv:1805.04155):

  * P1 triangles, one integration point, weight = the triangle's area;
  * strain in Voigt form [e11, e22, 2 e12], stress and plastic strain with
    the plane-strain fourth component [s11, s22, s12, s33];
  * isotropic elasticity s = 2G dev(e) + K tr(e) I on the four components;
  * Drucker-Prager fitted to Mohr-Coulomb in plane strain,
    eta = 3 tan(phi) / sqrt(9 + 12 tan(phi)^2), c_dp = 3 c / sqrt(...),
    with the return to the smooth cone or to the apex.
"""
from __future__ import annotations

import numpy as np

SQRT2 = np.sqrt(2.0)


def lame(young: float, poisson: float):
    """(shear G, bulk K)."""
    return young / (2.0 * (1.0 + poisson)), young / (3.0 * (1.0 - 2.0 * poisson))


def dp_fit(cohesion: float, friction_angle: float):
    """(eta, c_dp) of the plane-strain Drucker-Prager fit."""
    t = np.tan(friction_angle)
    den = np.sqrt(9.0 + 12.0 * t * t)
    return 3.0 * t / den, 3.0 * cohesion / den


class P1:
    """Gradients and areas of a triangle mesh: b = dN/dx, c = dN/dy, (n_e, 3)."""

    def __init__(self, coords: np.ndarray, elems: np.ndarray):
        self.elems = np.asarray(elems, np.int64)
        self.n_nodes = coords.shape[0]
        x = coords[self.elems, 0]
        y = coords[self.elems, 1]
        det = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
        if np.any(det == 0.0):
            raise ValueError("degenerate triangle in the mesh")
        self.area = 0.5 * np.abs(det)
        d = det[:, None]
        self.b = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], 1) / d
        self.c = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], 1) / d

    def strain(self, u: np.ndarray) -> np.ndarray:
        """(3, n_e) Voigt strain of the nodal displacement u (n_n, 2)."""
        ux, uy = u[self.elems, 0], u[self.elems, 1]
        return np.stack([(self.b * ux).sum(1), (self.c * uy).sum(1),
                         (self.c * ux + self.b * uy).sum(1)])

    def force(self, s: np.ndarray) -> np.ndarray:
        """(n_n, 2) internal force sum_e area B^T s[:3] of the stress s (>= 3, n_e)."""
        w = self.area
        fx = w[:, None] * (self.b * s[0][:, None] + self.c * s[2][:, None])
        fy = w[:, None] * (self.c * s[1][:, None] + self.b * s[2][:, None])
        out = np.zeros((self.n_nodes, 2))
        out[:, 0] = np.bincount(self.elems.ravel(), fx.ravel(), self.n_nodes)
        out[:, 1] = np.bincount(self.elems.ravel(), fy.ravel(), self.n_nodes)
        return out


def elastic_stress(et: np.ndarray, shear: float, bulk: float) -> np.ndarray:
    """(4, n) stress of the elastic strain et (4, n) = [e11, e22, 2 e12, e33]."""
    tr = et[0] + et[1] + et[3]
    return np.stack([2.0 * shear * (et[0] - tr / 3.0) + bulk * tr,
                     2.0 * shear * (et[1] - tr / 3.0) + bulk * tr,
                     shear * et[2],
                     2.0 * shear * (et[3] - tr / 3.0) + bulk * tr])


def return_map(e4: np.ndarray, ep_prev: np.ndarray, shear: float, bulk: float,
               eta: float, c_dp: float):
    """Drucker-Prager return map of the total strain e4 (4, n) from the
    plastic strain ep_prev (4, n) -> (stress (4, n), plastic strain (4, n),
    yield function of the trial stress (n,)).  The apex plastic strain is
    e4 - c / (3 K eta) on the normal components."""
    et = e4 - ep_prev
    s_tr = elastic_stress(et, shear, bulk)
    p = (s_tr[0] + s_tr[1] + s_tr[3]) / 3.0
    dev = np.stack([s_tr[0] - p, s_tr[1] - p, s_tr[2], s_tr[3] - p])
    # |dev s| with the shear counted twice
    rho = np.sqrt(np.maximum(dev[0] ** 2 + dev[1] ** 2 + 2.0 * dev[2] ** 2 + dev[3] ** 2, 0.0))
    f_tr = rho / SQRT2 + eta * p - c_dp
    apex_line = eta * p - bulk * eta * eta * rho / (shear * SQRT2) - c_dp
    smooth = (f_tr > 0.0) & (apex_line <= 0.0)
    apex = (f_tr > 0.0) & (apex_line > 0.0)
    lam = np.where(smooth, f_tr / (shear + bulk * eta * eta), 0.0)
    safe = np.where(rho > 0.0, rho, 1.0)
    nrm = dev / safe                      # unit deviatoric direction (shear once)
    # flow direction in strain space: n / sqrt2 + eta / 3 on the normal
    # components, the engineering shear doubled
    flow = np.stack([nrm[0] / SQRT2 + eta / 3.0, nrm[1] / SQRT2 + eta / 3.0,
                     2.0 * nrm[2] / SQRT2, nrm[3] / SQRT2 + eta / 3.0])
    ep = np.where(smooth, ep_prev + lam * flow, ep_prev)
    shift = c_dp / (3.0 * bulk * eta)
    ep_apex = np.stack([e4[0] - shift, e4[1] - shift, e4[2], e4[3] - shift])
    ep = np.where(apex, ep_apex, ep)
    s = elastic_stress(e4 - ep, shear, bulk)
    return s, ep, f_tr


def total_strain(geo: P1, u: np.ndarray, e0: np.ndarray | None) -> np.ndarray:
    """(4, n_e) strain of u with e33 = 0, plus the eigenstrain e0 (4,)."""
    e3 = geo.strain(u)
    e4 = np.vstack([e3, np.zeros((1, e3.shape[1]))])
    if e0 is not None:
        e4 = e4 + e0[:, None]
    return e4
