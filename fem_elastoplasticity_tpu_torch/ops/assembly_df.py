"""The df32 preset's f64 residual helpers and elastic predictor.

Counterpart of `fem_elastoplasticity_tpu/ops/assembly_df.py`.  The JAX
package evaluates the Newton residual in double-float (two-f32) arithmetic
because a TPU has no f64; the port evaluates the same quantities in f64.
What remains to port is the f64 <-> f32-pair split at the API edge, the f64
elastic application K_el u (matrix-free or on the residual operators), its
f32 counterpart on the f32 heads of the residual operators (the high-order
predictor's CG operator), the dense solver's f32 elastic factors, and the
elastic predictor's iterative refinement: an f32 inner solve against an
f64 residual.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from . import assembly as asm
from .spmv import EllMatrix, sp_matvec


def split_f64_np(x) -> tuple:
    """Host-side exact f64 -> (hi, lo) f32 split (numpy arrays)."""
    x64 = np.asarray(x, np.float64)
    hi = x64.astype(np.float32)
    lo = (x64 - hi.astype(np.float64)).astype(np.float32)
    return hi, lo


def elastic_stress(e: torch.Tensor, shear: float, bulk: float) -> torch.Tensor:
    """Plane-strain elastic stress D_el e from (3, n_int) strains.

    D_el = [[dd, oo, 0], [oo, dd, 0], [0, 0, shear]], dd = 4G/3 + K,
    oo = -2G/3 + K (`assembly_df.elastic_stress_df`).
    """
    dd = 4.0 * shear / 3.0 + bulk
    oo = -2.0 * shear / 3.0 + bulk
    return torch.stack([e[0] * dd + e[1] * oo, e[0] * oo + e[1] * dd, e[2] * shear])


def elastic_apply(geom: asm.Geometry, u: torch.Tensor, shear: float, bulk: float):
    """Matrix-free K_el u (`assembly_df.elastic_apply_df`)."""
    return asm.internal_force(geom, elastic_stress(asm.strains(geom, u), shear, bulk))


def elastic_apply_csr(G, S, u: torch.Tensor, shear: float, bulk: float):
    """Assembled K_el u = S(D_el (G u)) through K1, or K6 on ELL operators
    (`elastic_apply_slot_df`).  G, S: the residual operators (`ops.spmv`)."""
    e = sp_matvec(G, u).reshape(3, -1)
    return sp_matvec(S, elastic_stress(e, shear, bulk).reshape(-1))


def f32_heads(G, S) -> tuple:
    """The f32 heads of the f64 residual operators (`ops.spmv.CsrMatrix` or
    `EllMatrix`): the same structure, values rounded to nearest, as the
    JAX package's `vals_hi` streams are (an ELL operator's tail too)."""
    def head(A):
        if isinstance(A, EllMatrix):
            return A._replace(values=A.values.to(torch.float32),
                              tail_values=A.tail_values.to(torch.float32))
        return A._replace(values=A.values.to(torch.float32))

    return head(G), head(S)


def elastic_apply_gs32(G32, S32, v: torch.Tensor, shear: float, bulk: float):
    """f32 K_el v = S32 (D_el (G32 v)) on the f32 heads of the residual
    operators (`f32_heads`), through K3's CSR kernel (K6 on ELL heads): the high-order
    predictor's CG operator (`assembly_df.elastic_apply_gs32`)."""
    e = sp_matvec(G32, v.to(torch.float32)).reshape(3, -1)
    return sp_matvec(S32, elastic_stress(e, shear, bulk).reshape(-1))


def dense_elastic_factors(geom32: asm.Geometry, D32: torch.Tensor, plan: asm.DensePlan):
    """The f32 elastic stiffness K_free of the dense df32 solver, as the tsx
    and footing models form it: returns (L, Ki), L the Cholesky factor of
    K_free (the predictor's inner solve) and Ki the explicit inverse of its
    Jacobi-scaled form, unscaled (elastic Newton iterations as one matrix
    product).  geom32: the f32 geometry heads; D32: the f32 elastic
    tangent lanes."""
    K_free = asm.assemble_dense_free(asm.element_stiffness(geom32, D32), plan)
    L = torch.linalg.cholesky(K_free)
    dsc = torch.rsqrt(torch.diagonal(K_free))
    Ls = torch.linalg.cholesky(K_free * dsc[:, None] * dsc[None, :])
    eye = torch.eye(plan.n_free, dtype=torch.float32, device=K_free.device)
    Ki = torch.cholesky_solve(eye, Ls) * dsc[:, None] * dsc[None, :]
    return L, Ki


def refine_elastic_solve_with(
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    solve_fn: Callable[[torch.Tensor], torch.Tensor],
    u0: torch.Tensor,
    f_ext: torch.Tensor,
    iters: int = 4,
) -> torch.Tensor:
    """f64-accurate elastic solve K u = f_ext by iterative refinement.

    Each pass forms the residual in f64 (`apply_fn`, K_el u), rounds it to
    f32 for `solve_fn` (an approximate f32 K^{-1} on the free subspace, zero
    on constrained DOFs) and adds the f32 correction in f64.  Each pass
    gains about cond*eps32 (~1e-4 here), so 4 passes reach ~1e-14.
    """
    u = u0
    for _ in range(iters):
        r = f_ext - apply_fn(u)
        du = solve_fn(r.to(torch.float32))
        u = u + du.to(u.dtype)
    return u


def refine_elastic_solve_df(
    chol: torch.Tensor,
    free_idx: torch.Tensor,
    apply_fn: Callable[[torch.Tensor], torch.Tensor],
    u0: torch.Tensor,
    f_ext: torch.Tensor,
    iters: int = 4,
) -> torch.Tensor:
    """Elastic predictor: f32 Cholesky factor `chol` of K_free as the inner
    solve, refined against the f64 residual (`refine_elastic_solve_df`)."""

    def solve_fn(r32: torch.Tensor) -> torch.Tensor:
        du = torch.zeros_like(r32)
        du[free_idx] = torch.cholesky_solve(r32[free_idx, None], chol)[:, 0]
        return du

    return refine_elastic_solve_with(apply_fn, solve_fn, u0, f_ext, iters)
