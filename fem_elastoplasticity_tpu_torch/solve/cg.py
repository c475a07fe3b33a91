"""Projected preconditioned conjugate gradients: a host loop over device tensors.

Port of `fem_elastoplasticity_tpu/solve/cg.py` (`solve_cg` with
`structure="while"`, and the block-Jacobi preconditioner).  The JAX package
runs the iteration as a `while_loop` on the device; here the loop is
Python, and the stopping test reads one boolean back per iteration.  The
iterates and the iteration count are exactly the while-loop's: `alpha`,
`beta`, the breakdown guard and the right-hand-side scale stay device
tensors, so no scalar passes through a Python float (on CUDA a division by
a Python scalar is a product with its rounded reciprocal).

Dirichlet constraints are enforced by a multiplicative projector (the input
and output of the operator are masked).  Deflation (A-DEF2) is not ported.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor  # |r_k|_M of the unscaled system
    converged: bool  # the residual met the tolerance within maxiter
    # preconditioned-residual reduction |r_k|_M / |b|_M: 1.0 = no progress,
    # tol = converged exactly at the requested floor
    rel_residual: torch.Tensor


def block_jacobi_preconditioner(blocks: torch.Tensor, free: torch.Tensor):
    """Build M^{-1} from (n_n, 2, 2) nodal diagonal blocks.

    Constrained DOFs get identity rows so the inverse stays well-defined;
    the projector removes their effect anyway.  Returns apply(r) on flat
    (2*n_n,) vectors.
    """
    free2 = free.reshape(-1, 2)
    eye = torch.eye(2, dtype=blocks.dtype, device=blocks.device)
    mask = free2[:, :, None] & free2[:, None, :]
    b = torch.where(mask, blocks, torch.zeros_like(blocks))
    b = b + eye * (~free2).to(blocks.dtype)[:, :, None]
    a_, b_, c_, d_ = b[:, 0, 0], b[:, 0, 1], b[:, 1, 0], b[:, 1, 1]
    det = a_ * d_ - b_ * c_
    inv = (
        torch.stack(
            [torch.stack([d_, -b_], dim=-1), torch.stack([-c_, a_], dim=-1)], dim=-2
        )
        / det[:, None, None]
    )

    def apply(r):
        return torch.einsum("nij,nj->ni", inv, r.reshape(-1, 2)).reshape(-1)

    return apply


def solve_cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    free: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol=1e-12,
    maxiter: int = 1000,
    structure: str = "while",
    deflate=None,
) -> CGResult:
    """Projected preconditioned CG on the free-DOF subspace.

    Args:
      matvec: full-space operator v -> K v (symmetric on the free subspace).
      b:      (n_dofs,) right-hand side.
      free:   (n_n, 2) or (n_dofs,) boolean mask of unknowns.
      x0:     initial guess; its constrained part is zeroed (the returned x
              is zero on constrained DOFs).
      tol:    relative residual tolerance on the preconditioned norm; a
              Python float or a 0-d tensor of b's dtype (the Newton
              solver's forcing term).

    Non-convergence is not silent: `CGResult.converged` is False when the
    iteration cap was hit before the tolerance, or when the breakdown guard
    (p.Ap <= 0: stagnation at the dtype floor or an indefinite operator)
    stopped the iteration; `solve.newton` treats that like Newton
    divergence.
    """
    if deflate is not None:
        raise NotImplementedError("solve_cg: deflation is not ported")
    if structure != "while":
        raise NotImplementedError(f"solve_cg: structure {structure!r} is not ported")
    fmask = free.reshape(-1)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    proj = lambda v: torch.where(fmask, v, zero)  # noqa: E731
    A = lambda v: proj(matvec(proj(v)))  # noqa: E731
    M = precond if precond is not None else (lambda r: r)

    b = proj(b)
    # scale normalization: CG is scale-invariant in exact arithmetic, but a
    # tiny right-hand side (a ~1e-13 Newton residual in an f32 solve) drives
    # every inner product into the denormal range.  Solve K (x/s) = b/s
    # with s = max|b| and rescale at the end.
    bscale = b.abs().max()
    ok_b = bscale > 0.0
    inv_s = torch.where(ok_b, one / torch.where(ok_b, bscale, one), zero)
    b = b * inv_s

    if x0 is None:
        x = torch.zeros_like(b)
        r = b
        z = proj(M(r))
        gamma = r @ z
        bnorm = torch.sqrt(gamma.abs())
    else:
        x = proj(x0) * inv_s
        r = b - A(x)
        z = proj(M(r))
        gamma = r @ z
        bnorm = torch.sqrt(b @ proj(M(b)))
    limit = tol * bnorm

    p = z
    k = 0
    # the stopping test of the while-loop: one host read per iteration
    go = k < maxiter and bool(torch.sqrt(gamma.abs()) > limit)
    while go:
        Ap = A(p)
        pAp = p @ Ap
        # breakdown guard: keep the best iterate and the current gamma, and
        # stop; `converged` then says whether the tolerance was reached
        ok = pAp > 0.0
        alpha = torch.where(ok, gamma / torch.where(ok, pAp, one), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = proj(M(r))
        gamma_new = torch.where(ok, r @ z, gamma)
        beta = torch.where(ok, gamma_new / torch.where(gamma != 0.0, gamma, one), zero)
        p = z + beta * p
        gamma = gamma_new
        k += 1
        go = k < maxiter and bool(ok & (torch.sqrt(gamma.abs()) > limit))
    res = torch.sqrt(gamma.abs())
    return CGResult(
        x=x * bscale,
        iters=k,
        residual=res * bscale,
        converged=bool(res <= limit),
        rel_residual=res / torch.where(bnorm > 0.0, bnorm, one),
    )
