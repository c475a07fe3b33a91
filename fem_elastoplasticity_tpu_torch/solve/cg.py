"""Projected preconditioned conjugate gradients: a host loop over device tensors.

Port of `fem_elastoplasticity_tpu/solve/cg.py` (`solve_cg` with
`structure="while"` or `"scan"` and its A-DEF2 deflation, `deflation_harvest`, and the
block-Jacobi preconditioner), and `solve_cg_members`, the same iteration
for a batch of independent systems (the vmapped solve of a material
ensemble).  The JAX package
runs the iteration as a `while_loop` on the device; here the loop is
Python, and the stopping test reads one boolean back per iteration
(`structure="while"`), or the loop runs a fixed `maxiter` trips with the
state frozen once the test fires and no read inside it (`"scan"`).  The
iterates and the iteration count are exactly the while-loop's: `alpha`,
`beta`, the breakdown guard and the right-hand-side scale stay device
tensors, so no scalar passes through a Python float (on CUDA a division by
a Python scalar is a product with its rounded reciprocal).

Dirichlet constraints are enforced by a multiplicative projector (the input
and output of the operator are masked).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch

from ..ops.assembly import Geometry, node_block_diagonal


class CGResult(NamedTuple):
    x: torch.Tensor
    iters: int
    residual: torch.Tensor  # |r_k|_M of the unscaled system
    converged: bool  # the residual met the tolerance within maxiter
    # preconditioned-residual reduction |r_k|_M / |b|_M: 1.0 = no progress,
    # tol = converged exactly at the requested floor; a deflated solve
    # reports it in the undeflated preconditioner's norm
    rel_residual: torch.Tensor
    # the final preconditioned residual M r, unscaled (`deflation_harvest`
    # reads it)
    z: torch.Tensor


def block_jacobi_preconditioner(blocks: torch.Tensor, free: torch.Tensor):
    """Build M^{-1} from (n_n, 2, 2) nodal diagonal blocks.

    Constrained DOFs get identity rows so the inverse stays well-defined;
    the projector removes their effect anyway.  Returns apply(r) on flat
    (2*n_n,) vectors.  Member-batched blocks (B, n_n, 2, 2) give apply(r)
    on (B, 2*n_n) rows, each member with its own blocks.
    """
    free2 = free.reshape(-1, 2)
    eye = torch.eye(2, dtype=blocks.dtype, device=blocks.device)
    mask = free2[:, :, None] & free2[:, None, :]
    b = torch.where(mask, blocks, torch.zeros_like(blocks))
    b = b + eye * (~free2).to(blocks.dtype)[:, :, None]
    a_, b_, c_, d_ = b[..., 0, 0], b[..., 0, 1], b[..., 1, 0], b[..., 1, 1]
    det = a_ * d_ - b_ * c_
    inv = (
        torch.stack(
            [torch.stack([d_, -b_], dim=-1), torch.stack([-c_, a_], dim=-1)], dim=-2
        )
        / det[..., None, None]
    )
    if blocks.dim() == 4:
        n_b = blocks.shape[0]
        return lambda r: torch.einsum("bnij,bnj->bni", inv, r.reshape(n_b, -1, 2)).reshape(n_b, -1)

    def apply(r):
        return torch.einsum("nij,nj->ni", inv, r.reshape(-1, 2)).reshape(-1)

    return apply


def stiffness_block_jacobi(geom: Geometry, d: torch.Tensor, free: torch.Tensor):
    """`block_jacobi_preconditioner` of the stiffness of the material
    tangent d (3, 3, n_int): its nodal 2x2 diagonal blocks."""
    return block_jacobi_preconditioner(node_block_diagonal(geom, d), free)


def plastic_cg_tol(cg_tol: Optional[float], dtype: torch.dtype) -> float:
    """The plastic problems' CG tolerance: cg_tol, or 1e-14 in f64 and 2e-7
    in f32 (the preconditioned-residual floor; tighter stalls and trips the
    breakdown guard), JAX `models/tsx_tunnel.py:156-159`."""
    if cg_tol is not None:
        return cg_tol
    return 2e-7 if dtype == torch.float32 else 1e-14


def solve_cg(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    free: torch.Tensor,
    x0: Optional[torch.Tensor] = None,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol=1e-12,
    maxiter: int = 1000,
    structure: str = "while",
    deflate: Optional[torch.Tensor] = None,
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
      structure: "while" (stop at the test, one host read an iteration) or
              "scan" (JAX `solve/cg.py:272-303`): `maxiter` trips, each
              trip's new state taken by `torch.where` only while the test
              has not fired (converged, or the breakdown guard), so the
              iterates, the count and the flag are the while loop's, and
              the loop reads nothing back until it ends.

      deflate: optional (n_dofs, k) recycled deflation basis W (orthonormal
              columns, all-zero columns for empty slots): two-level
              deflated PCG in the A-DEF2 form (Tang, Nabben, Vuik and
              Erlangga, J. Sci. Comput. 2009).  PCG starts from
              x0 = W E^-1 W^T b (E = W^T A W, so W^T r0 = 0) and each
              preconditioner application z = M r is followed by the coarse
              correction z - W E^-1 ((AW)^T z - W^T r).  A factor of the
              scaled E that fails (an indefinite tangent) switches the
              corrections off for the solve.  x0 must be None.  An all-zero
              basis gives plain PCG bit for bit.

    The stopping scale is |b| in the norm of the undeflated
    preconditioner M0 in both cases: the deflated start residual's norm
    would tighten the tolerance by what the basis captured, and b's norm
    in the deflated preconditioner is inflated by the coarse term
    ~ (w.b)^2 / lambda_small.  A deflated solve reports its progress
    (`rel_residual`) in the M0 norm too, so that `cg_cap_relax` keeps one
    calibration.

    Non-convergence is not silent: `CGResult.converged` is False when the
    iteration cap was hit before the tolerance, or when the breakdown guard
    (p.Ap <= 0: stagnation at the dtype floor or an indefinite operator)
    stopped the iteration; `solve.newton` treats that like Newton
    divergence.
    """
    if deflate is not None and x0 is not None:
        raise ValueError("solve_cg: deflate needs x0=None")
    if structure not in ("while", "scan"):
        raise ValueError(f"solve_cg: unknown structure {structure!r}")
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

    M0 = M
    if deflate is not None:
        W = torch.where(fmask[:, None], deflate, zero)
        k = W.shape[1]
        AW = torch.stack([A(W[:, j]) for j in range(k)], dim=1)
        # the Gram matrix in the A inner product; empty slots get a unit
        # diagonal (their coefficients multiply zero columns).  Symmetric
        # unit-diagonal scaling and a small jitter keep the f32 factor
        # well posed across the basis' Rayleigh quotients
        eye = torch.eye(k, dtype=b.dtype, device=b.device)
        E = W.T @ AW
        E = 0.5 * (E + E.T) + torch.diag(torch.where((W * W).sum(0) > 0.5, zero, one))
        sE = torch.rsqrt(torch.clamp(torch.diagonal(E), min=1e-30))
        Es = E * sE[:, None] * sE[None, :] + 1e-5 * eye
        Lc, info = torch.linalg.cholesky_ex(Es)
        ok_d = (info == 0) & torch.isfinite(Lc).all()
        # the explicit k x k inverse, once a solve
        Ei = torch.cholesky_solve(eye, Lc)

        def dsolve(t):
            return torch.where(ok_d, sE * (Ei @ (sE * t)), zero)

        def deflated(r):
            # A-DEF2: the coarse correction after M0
            z = M0(r)
            return z - W @ dsolve(AW.T @ z - W.T @ r)

        M = deflated
        mu = dsolve(W.T @ b)
        x = W @ mu
        r = b - AW @ mu
        z = proj(M(r))
        gamma = r @ z
        bnorm = torch.sqrt((b @ proj(M0(b))).abs())
    elif x0 is None:
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

    def step(x, r, z, p, gamma):
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
        return x, r, z, z + beta * p, gamma_new, ok

    p = z
    if structure == "scan":
        # fixed trips; `done` freezes the state, so the trips after the
        # test fired change nothing (JAX `solve/cg.py:272-303`)
        k_t = torch.zeros((), dtype=torch.int64, device=b.device)
        done = torch.sqrt(gamma.abs()) <= limit
        for _ in range(maxiter):
            x1, r1, z1, p1, gamma1, ok = step(x, r, z, p, gamma)
            x, r = torch.where(done, x, x1), torch.where(done, r, r1)
            z, p = torch.where(done, z, z1), torch.where(done, p, p1)
            gamma = torch.where(done, gamma, gamma1)
            k_t = torch.where(done, k_t, k_t + 1)
            done = done | (torch.sqrt(gamma1.abs()) <= limit) | ~ok
        k = int(k_t)
    else:
        k = 0
        # the stopping test of the while-loop: one host read per iteration
        go = k < maxiter and bool(torch.sqrt(gamma.abs()) > limit)
        while go:
            x, r, z, p, gamma, ok = step(x, r, z, p, gamma)
            k += 1
            go = k < maxiter and bool(ok & (torch.sqrt(gamma.abs()) > limit))
    res = torch.sqrt(gamma.abs())
    # progress in the undeflated preconditioner's norm (one M0 at exit)
    res_rep = res if deflate is None else torch.sqrt((r @ proj(M0(r))).abs())
    return CGResult(
        x=x * bscale,
        iters=k,
        residual=res * bscale,
        converged=bool(res <= limit),
        rel_residual=res_rep / torch.where(bnorm > 0.0, bnorm, one),
        z=z * bscale,
    )


class MembersCGResult(NamedTuple):
    """`solve_cg_members`: each field with a leading member axis, on the
    device."""

    x: torch.Tensor  # (B, n_dofs)
    iters: torch.Tensor  # (B,) int64, the iterations each member took
    converged: torch.Tensor  # (B,) bool
    host_reads: int  # stopping tests read back to the host: one an iteration


def solve_cg_members(
    matvec: Callable[[torch.Tensor], torch.Tensor],
    b: torch.Tensor,
    free: torch.Tensor,
    precond: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    tol=1e-12,
    maxiter: int = 1000,
) -> MembersCGResult:
    """`solve_cg` (x0 None, no deflation) for B independent systems at once.

    matvec and precond map (B, n_dofs) rows to rows, member by member; b is
    (B, n_dofs), free the shared mask; tol a float or a (B,) tensor (each
    member's forcing term).  Each member follows its own `solve_cg` loop:
    its scale, its tolerance, its breakdown guard and its count.  A member
    whose own test stops its loop keeps its iterate, residual and search
    direction from then on, bit for bit, as the JAX package's vmapped
    while-loop keeps a finished lane, while the others run on.  One host
    read an iteration serves the whole batch: whether any member runs."""
    fmask = free.reshape(-1)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    one = torch.ones((), dtype=b.dtype, device=b.device)
    proj = lambda v: torch.where(fmask, v, zero)  # noqa: E731
    A = lambda v: proj(matvec(proj(v)))  # noqa: E731
    M = precond if precond is not None else (lambda r: r)
    dot = lambda u, v: (u * v).sum(dim=-1)  # noqa: E731

    b = proj(b)
    bscale = b.abs().amax(dim=-1)
    ok_b = bscale > 0.0
    inv_s = torch.where(ok_b, one / torch.where(ok_b, bscale, one), zero)
    b = b * inv_s[:, None]
    x = torch.zeros_like(b)
    r = b
    z = proj(M(r))
    gamma = dot(r, z)
    limit = torch.as_tensor(tol, dtype=b.dtype, device=b.device) * torch.sqrt(gamma.abs())
    p = z
    iters = torch.zeros(b.shape[0], dtype=torch.int64, device=b.device)
    run = torch.sqrt(gamma.abs()) > limit
    k, reads = 0, 1
    go = k < maxiter and bool(run.any())
    while go:
        Ap = A(p)
        pAp = dot(p, Ap)
        ok = pAp > 0.0
        alpha = torch.where(ok, gamma / torch.where(ok, pAp, one), zero)[:, None]
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z_new = proj(M(r_new))
        gamma_new = torch.where(ok, dot(r_new, z_new), gamma)
        beta = torch.where(ok, gamma_new / torch.where(gamma != 0.0, gamma, one), zero)
        p_new = z_new + beta[:, None] * p
        keep = run[:, None]
        x, r, z = torch.where(keep, x_new, x), torch.where(keep, r_new, r), torch.where(keep, z_new, z)
        p = torch.where(keep, p_new, p)
        gamma = torch.where(run, gamma_new, gamma)
        iters = iters + run.to(torch.int64)
        k += 1
        run = run & ok & (torch.sqrt(gamma.abs()) > limit)
        go = k < maxiter and bool(run.any())
        reads += 1
    converged = torch.sqrt(gamma.abs()) <= limit
    return MembersCGResult(x=x * bscale[:, None], iters=iters, converged=converged,
                           host_reads=reads)


def deflation_harvest(W: torch.Tensor, ring: int, vecs, gates=None):
    """Insert candidate vectors into the recycled deflation basis.

    W: (n, k) orthonormal columns (zero columns are empty slots); ring: the
    next slot to overwrite (oldest first); vecs: candidates, e.g. a tangent
    solve's solution x and its final preconditioned residual z; gates: an
    optional bool per candidate, False skips it without using a slot (the
    residual of a converged solve is noise at the tolerance floor).  Each
    candidate is orthogonalized against the basis (two passes of
    Gram-Schmidt) and kept if at least 1e-3 of its norm survives; columns
    are never changed after insertion.  Returns (W, ring), W a new tensor
    when a candidate was inserted."""
    k = W.shape[1]
    gates = [None] * len(vecs) if gates is None else gates
    tiny = torch.tensor(1e-30, dtype=W.dtype, device=W.device)
    for v, gate in zip(vecs, gates):
        if gate is not None and not gate:
            continue
        nv0 = torch.sqrt(v @ v)
        v1 = v - W @ (W.T @ v)
        v1 = v1 - W @ (W.T @ v1)
        nv = torch.sqrt(v1 @ v1)
        if bool(nv > 1e-3 * (nv0 + tiny)):  # False for NaN
            W = W.clone()
            W[:, ring % k] = v1 / nv
            ring = (ring + 1) % k
    return W, ring
