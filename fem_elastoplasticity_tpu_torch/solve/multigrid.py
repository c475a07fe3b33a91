"""Geometric multigrid V-cycle on assembled operators.

Port of the assembled-operator half of
`fem_elastoplasticity_tpu/solve/multigrid.py`: `build_hierarchy_ell`
(`:206-438`, `order_mode="fine_rcm"`, `pack_bf16`) and `make_vcycle_ell`
(`:875-1019`, `cycle="v"`).

The red-refinement hierarchy gives geometric multigrid for free: every
fine node is either a coarse node or the midpoint of two coarse parents, so
the prolongation P copies or averages and the restriction is R = P^T.
Every level's elastic operator, its transfers and its smoother blocks are
assembled once on the host (NumPy/SciPy, f64) and go to the device in f32,
in one of two formats (the JAX package's `fmt`):

* "slot" (the default): node layouts, no CSR operator on the device.  Each
  level's operator is stored once in 2x2 node blocks (`ops.spmv.node_blocks`,
  built here from the host CSR).  Smoothing is damped block-Jacobi
  (symmetric, so the V-cycle is SPD and valid as a CG preconditioner) in
  the fused kernel K4 (`ops.spmv.block_jacobi_sweep`) on f32 blocks or, on
  a level that is packed, in K5 on those blocks rounded to bf16: with the
  default `pack_bf16="auto"` the levels of 500,000 rows or more, as in the
  JAX package.  The fine level's f32 blocks are also CG's operator, the
  criterion's and the predictor's (K3's product, `ops.spmv.node_block_matvec`;
  on a packed fine level they keep f32 values of their own beside the bf16
  ones, on the same structure).  The transfers are `ops.spmv.NodeTransfer`s
  (K3's transfer kernel), which apply the V-cycle's masks and its
  correction's add in the same launch;
* "ell": `ops.spmv.EllMatrix` operators, P and R, applied by K6.  A level
  smooths through the unfused chain of the JAX package (its `_fused` is
  false for ELL): the masked residual r - A z through K6, then the 2x2
  block update elementwise.  The JAX package packs only slot levels, so an
  ELL level is never packed.

The coarsest level is solved with the explicit f32 inverse of its free-DOF
block.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from ..mesh.midpoints import _edge_scan
from ..ops import spmv
from ..ops.elements import ReferenceElement

# rows from which `pack_bf16="auto"` smooths a level from bf16 values
# (the JAX package's `multigrid.py:366-368`)
PACK_BF16_MIN_ROWS = 500_000
FORMATS = ("slot", "ell")


def packs_bf16(n_rows: int, pack_bf16="auto") -> bool:
    """Whether a slot-format level of `n_rows` rows smooths from bf16 values:
    "auto" packs from PACK_BF16_MIN_ROWS rows, True every level, False none."""
    if isinstance(pack_bf16, bool):
        return pack_bf16
    if pack_bf16 != "auto":
        raise ValueError(f"pack_bf16 must be 'auto', True or False; got {pack_bf16!r}")
    return n_rows >= PACK_BF16_MIN_ROWS


class MGLevel(NamedTuple):
    """One level on the device.  P and R are None on the coarsest level.
    On a slot level `op` is the fine level's f32 node blocks
    (`ops.spmv.NodeBlockMatrix`) and None below it, where the V-cycle
    reads `sweep_op` alone (the host CSR of every level stays in
    `build_hierarchy_ell`'s `coarse["levels"]`); P and R are
    `ops.spmv.NodeTransfer`s.  On an ELL level all three are
    `ops.spmv.EllMatrix`."""

    # (2n_n, 2n_n) f32 elastic operator, BC rows unit-diagonal
    op: Optional[Union[spmv.NodeBlockMatrix, spmv.EllMatrix]]
    inv: torch.Tensor  # (n_n, 2, 2) f32 damped block-Jacobi inverse
    free: torch.Tensor  # (2n_n,) bool
    aux: spmv.SweepAux
    # (2n_n, 2n_c) f32 prolongation from the level below, and R = P^T
    P: Optional[Union[spmv.NodeTransfer, spmv.EllMatrix]]
    R: Optional[Union[spmv.NodeTransfer, spmv.EllMatrix]]
    # the smoother's operator on a slot level: op in 2x2 node blocks, f32
    # (K4) or, on a packed level, bf16 (K5); None on an ELL level
    sweep_op: Optional[spmv.NodeBlockMatrix] = None


class Hierarchy(NamedTuple):
    levels: List[MGLevel]  # index 0 = coarsest
    inv0: torch.Tensor  # (n_free0, n_free0) f32 inverse of the coarsest free block
    free_idx0: torch.Tensor  # (n_free0,) int64 free DOFs of the coarsest level


def hierarchy_to_device(
    host_levels: Sequence[dict], inv0: np.ndarray, free_idx0: np.ndarray, device,
    pack_bf16="auto", fmt: str = "slot",
) -> Hierarchy:
    """Host level data -> `Hierarchy` on `device`.

    host_levels[l]: dict(K=scipy CSR (f64), inv=(n_n, 2, 2), free=(n_n, 2)
    or flat bool, P=scipy CSR or None on level 0).  fmt: "slot" (node
    blocks and node transfers) or "ell"; pack_bf16: `packs_bf16` for the
    slot levels.
    """
    if fmt not in FORMATS:
        raise ValueError(f"fmt must be one of {FORMATS}; got {fmt!r}")
    if fmt == "ell":
        to_transfer = lambda A: spmv.build_ell(A, device, np.float32)  # noqa: E731
    else:
        to_transfer = lambda A: spmv.node_transfer(A, device)  # noqa: E731

    levels = []
    for l, h in enumerate(host_levels):
        K = h["K"]
        free_flat = np.asarray(h["free"]).reshape(-1)
        P = R = None
        if h.get("P") is not None:
            Ph = sp.csr_matrix(h["P"])
            Rh = Ph.T.tocsr()
            Rh.sum_duplicates()
            P, R = to_transfer(Ph), to_transfer(Rh)
        if fmt == "ell":
            op, sweep_op = spmv.build_ell(K, device, np.float32), None
        else:
            # the level's f32 CSR lives only while its blocks are built
            blocks = spmv.node_blocks(spmv.csr_to_device(K, device, np.float32))
            sweep_op = blocks
            if packs_bf16(K.shape[0], pack_bf16):
                sweep_op = blocks._replace(block_values=blocks.block_values.to(torch.bfloat16))
            # the fine level's f32 blocks are CG's operator
            op = blocks if l == len(host_levels) - 1 else None
        levels.append(MGLevel(
            op=op,
            inv=torch.as_tensor(np.array(h["inv"], np.float32), device=device),
            free=torch.as_tensor(free_flat.astype(bool), device=device),
            aux=spmv.sweep_aux(h["inv"], free_flat, device),
            P=P, R=R,
            sweep_op=sweep_op,
        ))
    return Hierarchy(
        levels=levels,
        inv0=torch.as_tensor(np.array(inv0, np.float32), device=device),
        free_idx0=torch.as_tensor(np.array(free_idx0, np.int64), device=device),
    )


def build_hierarchy_ell(
    coords0: np.ndarray,
    elems0: np.ndarray,
    levels: int,
    free_fn: Callable[[np.ndarray], np.ndarray],
    shear: float,
    bulk: float,
    ref: ReferenceElement,
    omega: float = 0.7,
    device=None,
    fmt: str = "slot",
    pack_bf16="auto",
):
    """Host-side multigrid build: red refinement + locality ordering.

    Node ordering: reverse Cuthill-McKee on the finest mesh; each coarser
    level is ordered by its nodes' positions in the next-finer ordering
    (coarse nodes are a prefix of the finer level's node set under red
    refinement).

    Returns (hierarchy, perms, coarse):
      hierarchy: `Hierarchy` on `device`
      perms[l]:  new_of_old node map of level l
      coarse:    host data: `levels` (per level coords, elems, K, free, inv,
                 P), `inv0`, `free_idx0`, and of the finest level `fine_K`
                 (the BC-masked CSR the tangent refresh indexes),
                 `fine_free`, `fine_coords`
    fmt, pack_bf16: the device format and packing (`hierarchy_to_device`).
    """
    chain = []
    coords, elems = np.asarray(coords0, np.float64), np.asarray(elems0)
    chain.append((coords, elems, None))
    for _ in range(levels):
        v = elems
        directed = np.stack(
            [v[:, [1, 2]], v[:, [2, 0]], v[:, [0, 1]]], axis=1
        ).reshape(-1, 2)
        first_pos, edge_id, _ = _edge_scan(directed)
        owners = directed[first_pos]
        mids = 0.5 * (coords[owners[:, 0]] + coords[owners[:, 1]])
        coords_f = np.concatenate([coords, mids], axis=0)
        n_c = coords.shape[0]
        mid_nodes = (n_c + edge_id).reshape(-1, 3)
        m23, m31, m12 = mid_nodes[:, 0], mid_nodes[:, 1], mid_nodes[:, 2]
        v0, v1, v2 = v[:, 0], v[:, 1], v[:, 2]
        children = np.stack(
            [
                np.stack([v0, m12, m31], axis=1),
                np.stack([v1, m23, m12], axis=1),
                np.stack([v2, m31, m23], axis=1),
                np.stack([m12, m23, m31], axis=1),
            ],
            axis=1,
        ).reshape(-1, 3)
        chain.append((coords_f, children.astype(np.int64), owners))
        coords, elems = coords_f, children

    # fine RCM, then induce coarser orderings by restriction: level l's
    # nodes are ids 0..n_l-1 inside level l+1
    fine_orders = [None] * len(chain)
    noo_next = None
    for l in reversed(range(len(chain))):
        n_l = chain[l][0].shape[0]
        if l == len(chain) - 1:
            order_l = spmv.rcm_node_order(chain[-1][1], n_l)
        else:
            order_l = np.argsort(noo_next[:n_l], kind="stable")
        noo_next = np.empty(n_l, np.int64)
        noo_next[order_l] = np.arange(n_l)
        fine_orders[l] = order_l

    host_levels, perms = [], []
    prev_new_of_old = prev_n = None
    inv0 = idx0 = None
    for l, (c, e, par) in enumerate(chain):
        n_n = c.shape[0]
        order = fine_orders[l]
        c2, e2, new_of_old = spmv.permute_mesh(c, e, order)
        free2 = np.asarray(free_fn(c2))
        K = spmv.build_elastic_csr(c2, e2, ref, shear, bulk, free=free2)
        blocks = spmv.diag_blocks_csr(K, n_n)
        a_, b_, cc_, d_ = blocks[:, 0, 0], blocks[:, 0, 1], blocks[:, 1, 0], blocks[:, 1, 1]
        det = a_ * d_ - b_ * cc_
        inv = (
            np.stack([np.stack([d_, -b_], -1), np.stack([-cc_, a_], -1)], -2)
            / det[:, None, None]
        ) * omega
        P = None
        if l == 0:
            idx0 = np.nonzero(free2.reshape(-1))[0]
            K0 = K[idx0][:, idx0].toarray()
            c0, _ = sla.cho_factor(K0, lower=False)
            # the V-cycle is a preconditioner, so the f32 accuracy of the
            # explicit inverse is irrelevant to the CG trajectory
            inv0 = sla.cho_solve((c0, False), np.eye(K0.shape[0]))
        else:
            o = order
            isc = o < prev_n
            safe = np.maximum(o - prev_n, 0)
            pa2 = np.where(isc, prev_new_of_old[np.minimum(o, prev_n - 1)],
                           prev_new_of_old[par[safe, 0]])
            pb2 = np.where(isc, pa2, prev_new_of_old[par[safe, 1]])
            rows = np.arange(n_n)
            rP, cP, vP = [], [], []
            for d in range(2):
                rP.append(2 * rows + d)
                cP.append(2 * pa2 + d)
                vP.append(np.full(n_n, 0.5))
                rP.append(2 * rows + d)
                cP.append(2 * pb2 + d)
                vP.append(np.full(n_n, 0.5))
            P = sp.coo_matrix(
                (np.concatenate(vP), (np.concatenate(rP), np.concatenate(cP))),
                shape=(2 * n_n, 2 * prev_n),
            ).tocsr()
            P.sum_duplicates()
        host_levels.append(dict(coords=c2, elems=e2, K=K, free=free2, inv=inv, P=P))
        perms.append(new_of_old)
        prev_new_of_old, prev_n = new_of_old, n_n
    hierarchy = hierarchy_to_device(host_levels, inv0, idx0, device, pack_bf16, fmt)
    top = host_levels[-1]
    coarse = dict(
        levels=host_levels, inv0=inv0, free_idx0=idx0,
        fine_coords=top["coords"], fine_K=top["K"], fine_free=top["free"],
    )
    return hierarchy, perms, coarse


def make_vcycle_ell(hier: Hierarchy, nu=2, cycle: str = "v"):
    """V-cycle preconditioner application r -> z (approximate K^{-1} r).

    nu: smoothing sweeps, an int (symmetric) or a (pre, post) tuple.  The
    first pre-sweep from z = 0 is the damped block inverse applied to r (no
    operator application).  On a slot level the other sweeps and the masked
    residual are K4 launches on the level's node blocks, K5 on a packed
    level; on an ELL level a K6 product and elementwise ops each.  On a
    slot level each transfer is one K3 launch that also masks R's output
    with the coarse level's free DOFs, or adds P's masked output to z; on
    an ELL level a K6 launch and the elementwise `torch.where` (and add),
    the same operations, as the JAX package writes them
    (`multigrid.py:961`, `:1014-1015`).
    """
    if cycle != "v":
        raise NotImplementedError(f"make_vcycle_ell: cycle {cycle!r} is not ported")
    nu_pre, nu_post = (nu, nu) if isinstance(nu, int) else nu
    levels = hier.levels
    zero = torch.zeros((), dtype=torch.float32, device=hier.inv0.device)

    def block_inverse(lev: MGLevel, x: torch.Tensor) -> torch.Tensor:
        # the damped 2x2 block inverse through the sweep constants, own and
        # partner coefficient: the products and the sum of
        # einsum("nij,nj->ni", inv, x), elementwise (as a batched matrix
        # product the 114,056 blocks of level 4 take 0.12 ms in cuBLAS, more
        # than the rest of the cycle)
        return lev.aux.msf * x + lev.aux.mpr * x.reshape(-1, 2).flip(1).reshape(-1)

    def sweep(lev: MGLevel, z: torch.Tensor, r: torch.Tensor, update: bool = True):
        if lev.sweep_op is None:  # ELL
            res = torch.where(lev.free, r - spmv.sp_matvec(lev.op, z), zero)
            return z + torch.where(lev.free, block_inverse(lev, res), zero) if update else res
        return spmv.block_jacobi_sweep(lev.sweep_op, lev.aux, z, r, update)

    def restrict(li: int, res: torch.Tensor) -> torch.Tensor:
        # the right-hand side of level li - 1, masked by its free DOFs
        lev, free_c = levels[li], levels[li - 1].free
        if isinstance(lev.R, spmv.NodeTransfer):
            return spmv.transfer(lev.R, res, mask=free_c)
        return torch.where(free_c, spmv.sp_matvec(lev.R, res), zero)

    def prolong_add(lev: MGLevel, z: torch.Tensor, z_c: torch.Tensor) -> torch.Tensor:
        if isinstance(lev.P, spmv.NodeTransfer):
            return spmv.transfer(lev.P, z_c, mask=lev.free, z=z)
        return z + torch.where(lev.free, spmv.sp_matvec(lev.P, z_c), zero)

    def vcycle(li: int, r: torch.Tensor) -> torch.Tensor:
        # r: masked by the level's free DOFs
        lev = levels[li]
        if li == 0:
            z = torch.zeros_like(r)
            z[hier.free_idx0] = hier.inv0 @ r[hier.free_idx0]
            return torch.where(lev.free, z, zero)
        # first pre-sweep from z = 0: res = r exactly, so z = mask inv r
        z = torch.where(lev.free, block_inverse(lev, r), zero)
        for _ in range(nu_pre - 1):
            z = sweep(lev, z, r)
        res = sweep(lev, z, r, update=False)
        z = prolong_add(lev, z, vcycle(li - 1, restrict(li, res)))
        for _ in range(nu_post):
            z = sweep(lev, z, r)
        return z

    fine = levels[-1]
    return lambda r: vcycle(len(levels) - 1, torch.where(fine.free, r, zero))
