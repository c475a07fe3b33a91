"""Geometric multigrid V-cycles, matrix-free and on assembled operators.

Port of `fem_elastoplasticity_tpu/solve/multigrid.py`: the matrix-free
hierarchy of the tsx's `solver="mg"` (`build_hierarchy` `:42`, `prolong`
`:100`, `restrict` `:108`, `build_mg_levels` `:131`, `make_vcycle`
`:1022`): each level keeps its own geometry and material tangent, the
operator is the matrix-free tangent product, P averages a new node's two
parents and R = P^T adds half of each new node's residual to its parents
in a fixed order; and the assembled half, `build_hierarchy_ell`
(`:206-438`, `order_mode="fine_rcm"`, `pack_bf16`) and `make_vcycle_ell`
(`:875-1019`, `cycle="v"` or `"w"`).

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

`build_tangent_hierarchy` (`:441`) and `tangent_vcycle` (`:623`) make
the same hierarchy a tangent multigrid: every level refreshed from the
consistent tangent once a Newton iteration, the fine level by the element
scatter and each coarser one through a Galerkin value map (K3's CSR kernel),
with the smoother constants and the coarsest inverse rebuilt on the card.

`shard_hierarchy_ell` (`:821`) row-shards a hierarchy over the ranks of a
multi-device run (`parallel/sharding.py`): every level's operator, P and R
become `ops.spmv.RowShard`s, whose products, sweeps (K4's split-z
instance) and transfers run the rank's rows and gather them, so
`make_vcycle_ell` runs unchanged; the block inverses, the masks and the
coarse direct solve stay replicated.  `shard_tangent_hierarchy` does the
same for the tangent refresh: the fine element scatter lands on the rank's
slice of the values, and the Galerkin value maps run row-sharded.
"""
from __future__ import annotations

from typing import Callable, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import scipy.linalg as sla
import scipy.sparse as sp
import torch

from ..mesh.midpoints import _edge_scan
from ..models.materials import elastic_tangent_lanes
from ..ops import assembly as asm
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


def _red_refine(coords: np.ndarray, elems: np.ndarray):
    """One red refinement of a P1 mesh in the dtype of `coords`: (coords
    with the edge midpoints appended, the four children of every triangle,
    the (n_new, 2) parents of the new nodes).  New node n_c + k is the
    midpoint of unique edge k in owner orientation, the edge scan of
    `mesh.midpoints`."""
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
    return coords_f, children.astype(np.int64), owners


def refinement_chain(coords0: np.ndarray, elems0: np.ndarray, levels: int) -> list:
    """Red refinement of a P1 mesh `levels` times: [(coords, elems,
    parents), ...] from the given mesh (parents None) to the finest, in
    refinement order; a new node's parents are the ends of its edge."""
    chain = []
    coords, elems = np.asarray(coords0, np.float64), np.asarray(elems0)
    chain.append((coords, elems, None))
    for _ in range(levels):
        coords, elems, owners = _red_refine(coords, elems)
        chain.append((coords, elems, owners))
    return chain


# ---------------------------------------------------------------------------
# the matrix-free hierarchy (the tsx's solver="mg")
# ---------------------------------------------------------------------------
class HierarchyLevel(NamedTuple):
    """One level of `build_hierarchy`, on the host (the JAX package's
    `MGLevelArrays`)."""

    coords: np.ndarray  # (n_n, 2) in the coarsest level's dtype
    elems: np.ndarray  # (n_e, 3) int64
    free: np.ndarray  # (n_n, 2) bool
    parents: np.ndarray  # (n_new, 2) the coarse parents of the new nodes; (0, 2) on level 0


def build_hierarchy(coords0: np.ndarray, elems0: np.ndarray, levels: int,
                    free_fn: Callable[[np.ndarray], np.ndarray]) -> List[HierarchyLevel]:
    """Coarse-to-fine hierarchy by red refinement (JAX `multigrid.py:42`),
    index 0 the coarsest; the midpoints are computed in the dtype of
    `coords0` (the JAX package's df32 hierarchy starts from f32
    coordinates).  free_fn: coords -> (n_n, 2) free mask of a level."""
    coords, elems = np.asarray(coords0), np.asarray(elems0).astype(np.int64)
    out = [HierarchyLevel(coords, elems, np.asarray(free_fn(coords)), np.zeros((0, 2), np.int64))]
    for _ in range(levels):
        coords, elems, owners = _red_refine(coords, elems)
        out.append(HierarchyLevel(coords, elems, np.asarray(free_fn(coords)),
                                  owners.astype(np.int64)))
    return out


def prolong(v_c: torch.Tensor, parents: torch.Tensor) -> torch.Tensor:
    """Coarse DOF vector (2 n_c,) -> fine (2 n_f,): the coarse nodes keep
    their values, a new node takes its parents' mean (JAX `:100`)."""
    v2 = v_c.reshape(-1, 2)
    mid = 0.5 * (v2[parents[:, 0]] + v2[parents[:, 1]])
    return torch.cat([v2, mid]).reshape(-1)


def restrict_table(parents: np.ndarray, n_c: int) -> np.ndarray:
    """The gather table of `restrict`: for each coarse node, the positions
    in [halves ; halves] (the new nodes as first parents, then as second)
    that add into it, in the JAX package's segment-sum order."""
    keys = np.concatenate([parents[:, 0], parents[:, 1]]).astype(np.int64)
    _, table = asm._grouped_gather(keys, np.arange(keys.size), keys.size, n_rows=n_c)
    return table


def restrict(r_f: torch.Tensor, table: torch.Tensor, n_c: int) -> torch.Tensor:
    """P^T: fine residual (2 n_f,) -> coarse (2 n_c,) (JAX `:108`): a coarse
    node's own value plus half of each new node's it is a parent of, added
    one after another from zero (`restrict_table`; the JAX package's
    segment sum, without atomics)."""
    r2 = r_f.reshape(-1, 2)
    halves = 0.5 * r2[n_c:]
    both = torch.cat([halves, halves]).T.contiguous()  # (2, 2 n_new)
    scat = asm._gather_fold(both, table).T
    return (r2[:n_c] + scat).reshape(-1)


class MFLevel(NamedTuple):
    """A built level of the matrix-free hierarchy (the JAX package's
    `MGLevel` of `build_mg_levels`)."""

    geom: asm.Geometry
    d: torch.Tensor  # (3, 3, n_int) material tangent
    free_flat: torch.Tensor  # (2 n_n,) bool
    inv_blocks: torch.Tensor  # (n_n, 2, 2) damped block-Jacobi inverse
    parents: torch.Tensor  # (n_new, 2) int64
    rtable: torch.Tensor  # `restrict_table` into the level below (level 0: empty)


def build_mg_levels(hier: Sequence[HierarchyLevel], ref: ReferenceElement, d_fn, device,
                    omega: float = 0.7) -> List[MFLevel]:
    """Per-level geometry (in the dtype of the hierarchy's coordinates),
    tangent `d_fn(geom)` and damped block-Jacobi smoother (JAX `:131`)."""
    levels = []
    for li, lv in enumerate(hier):
        coords = torch.as_tensor(lv.coords, device=device)
        geom = asm.compute_geometry(coords, lv.elems, ref)
        d = d_fn(geom)
        blocks = asm.node_block_diagonal(geom, d)
        free2 = torch.as_tensor(lv.free, device=device)
        mask = free2[:, :, None] & free2[:, None, :]
        b = torch.where(mask, blocks, torch.zeros_like(blocks))
        eye = torch.eye(2, dtype=blocks.dtype, device=device)
        b = b + eye * (~free2).to(blocks.dtype)[:, :, None]
        a_, b_, c_, dd = b[:, 0, 0], b[:, 0, 1], b[:, 1, 0], b[:, 1, 1]
        det = a_ * dd - b_ * c_
        inv = (torch.stack([torch.stack([dd, -b_], -1), torch.stack([-c_, a_], -1)], -2)
               / det[:, None, None]) * omega
        n_c = hier[li - 1].coords.shape[0] if li else 0
        table = restrict_table(lv.parents, n_c) if li else np.zeros((0, 1), np.int64)
        levels.append(MFLevel(geom, d, free2.reshape(-1), inv,
                              torch.as_tensor(lv.parents, device=device),
                              torch.as_tensor(table, device=device)))
    return levels


def make_vcycle(levels: Sequence[MFLevel], coarse_solve, nu=2):
    """V-cycle preconditioner application r -> z on the matrix-free
    hierarchy (JAX `:1022`): damped block-Jacobi sweeps on each level's
    tangent product, `coarse_solve` (masked r -> z) on level 0.  nu: an
    int or a (pre, post) tuple; the first pre-sweep from z = 0 is the block
    inverse applied to r."""
    nu_pre, nu_post = (nu, nu) if isinstance(nu, int) else nu

    def block_apply(lev: MFLevel, x: torch.Tensor) -> torch.Tensor:
        return torch.einsum("nij,nj->ni", lev.inv_blocks, x.reshape(-1, 2)).reshape(-1)

    def smooth(lev: MFLevel, z, r, z_is_zero=False):
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        lo = 0
        if z_is_zero:
            # the first sweep from z = 0: res = r exactly
            z = torch.where(lev.free_flat, block_apply(lev, r), zero)
            lo = 1
        for _ in range(lo, nu_pre if z_is_zero else nu_post):
            res = torch.where(lev.free_flat, r - asm.tangent_matvec(lev.geom, lev.d, z), zero)
            z = z + torch.where(lev.free_flat, block_apply(lev, res), zero)
        return z

    def vcycle(li: int, r: torch.Tensor) -> torch.Tensor:
        lev = levels[li]
        zero = torch.zeros((), dtype=r.dtype, device=r.device)
        r = torch.where(lev.free_flat, r, zero)
        if li == 0:
            return torch.where(lev.free_flat, coarse_solve(r), zero)
        z = smooth(lev, torch.zeros_like(r), r, z_is_zero=True)
        res = torch.where(lev.free_flat, r - asm.tangent_matvec(lev.geom, lev.d, z), zero)
        z_c = vcycle(li - 1, restrict(res, lev.rtable, levels[li - 1].geom.n_nodes))
        z = z + torch.where(lev.free_flat, prolong(z_c, lev.parents), zero)
        return smooth(lev, z, r)

    return lambda r: vcycle(len(levels) - 1, r)


def fine_rcm_orders(chain: list) -> list:
    """Each level's node order (old id at each new position): reverse
    Cuthill-McKee on the finest mesh, and on every coarser level the order
    its nodes have in the next-finer one (coarse nodes are ids 0..n_l-1 of
    the finer level under red refinement)."""
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
    return fine_orders


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
    chain = refinement_chain(coords0, elems0, levels)
    fine_orders = fine_rcm_orders(chain)

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

    cycle: "v", or "w": each level below the fine one is visited twice, the
    second time on the masked residual its first visit left (one more
    masked-residual sweep and two more transfers a level), except where the
    level below is the coarsest (JAX `multigrid.py:955-962`).
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
    if cycle not in ("v", "w"):
        raise ValueError(f"make_vcycle_ell: unknown cycle {cycle!r}")
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
        if isinstance(spmv.local_of(lev.R), spmv.NodeTransfer):
            return spmv.transfer(lev.R, res, mask=free_c)
        return torch.where(free_c, spmv.sp_matvec(lev.R, res), zero)

    def prolong_add(lev: MGLevel, z: torch.Tensor, z_c: torch.Tensor) -> torch.Tensor:
        if isinstance(spmv.local_of(lev.P), spmv.NodeTransfer):
            return spmv.transfer(lev.P, z_c, mask=lev.free, z=z)
        return z + torch.where(lev.free, spmv.sp_matvec(lev.P, z_c), zero)

    def coarse_correct(li: int, r_c: torch.Tensor) -> torch.Tensor:
        # one visit (V) or two (W) to the level below li
        z_c = vcycle(li - 1, r_c)
        if cycle == "w" and li - 1 > 0:
            lev_c = levels[li - 1]
            z_c = z_c + vcycle(li - 1, sweep(lev_c, z_c, r_c, update=False))
        return z_c

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
        z = prolong_add(lev, z, coarse_correct(li, restrict(li, res)))
        for _ in range(nu_post):
            z = sweep(lev, z, r)
        return z

    fine = levels[-1]
    return lambda r: vcycle(len(levels) - 1, torch.where(fine.free, r, zero))


# ---------------------------------------------------------------------------
# row sharding over the ranks of a multi-device run
# ---------------------------------------------------------------------------
def shard_hierarchy_ell(hier: Hierarchy, group) -> Hierarchy:
    """This rank's row-sharded copy of `hier` (`shard_hierarchy_ell`, JAX
    `multigrid.py:821`): every level's `op`, `sweep_op`, P and R as
    `ops.spmv.RowShard`s of `group` (`ops.spmv.shard_rows`; the fine slot
    level's op and sweep_op stay one object); `inv`, `free`, `aux` (cut at
    each sweep), `inv0` and `free_idx0` replicated.  Raises on a level
    smoothed from bf16 values: K5 has no split-z instance."""
    for lev in hier.levels:
        if lev.sweep_op is not None and lev.sweep_op.block_values.dtype != torch.float32:
            raise NotImplementedError(
                "bf16-packed smoother streams are not row-sharded: build the hierarchy with "
                "pack_bf16=False for multi-device runs")

    def cut(A):
        return None if A is None else spmv.shard_rows(A, group)

    levels = []
    for lev in hier.levels:
        sweep_op = cut(lev.sweep_op)
        op = sweep_op if (lev.op is not None and lev.op is lev.sweep_op) else cut(lev.op)
        levels.append(lev._replace(op=op, sweep_op=sweep_op, P=cut(lev.P), R=cut(lev.R)))
    return hier._replace(levels=levels)


# ---------------------------------------------------------------------------
# the tangent hierarchy: every level refreshed once a Newton iteration
# ---------------------------------------------------------------------------
class TangentHierarchy(NamedTuple):
    """Device tables of the per-Newton-iteration tangent refresh
    (`build_tangent_hierarchy`), all positions in the levels' flat node-block
    values (`MGLevel.sweep_op.block_values.reshape(-1)`).  Row-sharded
    (`shard_tangent_hierarchy`): `dest` indexes the rank's slice of the fine
    values, `mhat` are `ops.spmv.RowShard`s, and `fine_counts` holds every
    rank's count of fine values."""

    geom: asm.Geometry  # the fine level's f32 geometry, from f32 coordinates
    # (n_elems, 2n_p, 2n_p) int64: each element-block entry's position in the
    # fine values, the values' size for a dropped (constrained) entry
    dest: torch.Tensor
    # mhat[l - 1]: the Galerkin value map of level l -> level l - 1, f32 CSR
    mhat: List[spmv.CsrMatrix]
    base: List[torch.Tensor]  # base[l - 1]: level l - 1's static f32 offset
    diag_blocks: List[torch.Tensor]  # per level, (n_n,) int64 diagonal block
    d0_idx: torch.Tensor  # flat positions in the coarsest (n_free0, n_free0)
    pos0_ff: torch.Tensor  # the level-0 values that land there
    n_free0: int
    fine_counts: Optional[tuple] = None


def _prolongation_rows(P) -> tuple:
    """The prolongation's rows padded to 2 (coarse DOF, weight) entries."""
    P = sp.csr_matrix(P)
    P.sum_duplicates()
    deg = np.diff(P.indptr)
    assert deg.max() <= 2, "a P1 prolongation row has at most two parents"
    n = P.shape[0]
    pidx = np.zeros((n, 2), np.int64)
    pw = np.zeros((n, 2), np.float64)
    r = np.repeat(np.arange(n), deg)
    k = np.arange(P.nnz) - np.repeat(P.indptr[:-1], deg)
    pidx[r, k] = P.indices
    pw[r, k] = P.data
    return pidx, pw


def build_tangent_hierarchy(hier: Hierarchy, coarse: dict, ref: ReferenceElement,
                            device=None) -> TangentHierarchy:
    """Host setup of the tangent multigrid (`build_tangent_hierarchy`,
    JAX `multigrid.py:441`) for a P1 slot hierarchy with f32 values on every
    level (`build_hierarchy_ell(fmt="slot", pack_bf16=False)`).

    The fine level's values are the elastic ones plus every element's
    tangent deviation (`element_corr_dest` mapped to the node blocks).  Each
    coarser level is the Galerkin restriction P^T K P of the level above:
    for nested P1 spaces its pattern is the built coarse operator's, and the
    map from the fine values to the coarse ones is a fixed sparse matrix
    (`Mhat`, at most four coarse entries a fine one through the 0.5 / 1.0
    weights of P), built here over the node-block value positions of both
    levels and applied on the card as one CSR product.  The static offset
    base = vals_c_elastic - Mhat vals_f_elastic (the constrained rows' unit
    diagonals) makes the elastic chain reproduce the built hierarchy.  The
    diagonal blocks give each level's smoother constants, and the coarsest
    level's free-free entries its dense matrix."""
    levels = coarse["levels"]
    top = len(levels) - 1
    fine = levels[top]
    g = asm.compute_geometry(torch.as_tensor(fine["coords"], dtype=torch.float32, device=device),
                             np.asarray(fine["elems"]), ref)
    if g.n_q != 1:
        raise NotImplementedError("the tangent hierarchy needs P1 elements (one point each)")
    for lev in hier.levels:
        if lev.sweep_op is None or lev.sweep_op.block_values.dtype != torch.float32:
            raise ValueError("the tangent hierarchy needs f32 node blocks on every level "
                             "(fmt='slot', pack_bf16=False)")
    n_vals = [lev.sweep_op.block_values.numel() for lev in hier.levels]
    dest = spmv.node_block_dest(
        spmv.element_corr_dest(fine["K"], np.asarray(fine["elems"]), fine["free"]),
        fine["K"], device).long()
    pad = dest.new_full((g.n_elems - dest.shape[0],) + tuple(dest.shape[1:]), -1)
    dest = torch.cat([dest, pad])
    dest = torch.where(dest >= 0, dest, n_vals[top])
    # every level's CSR entry -> its place in the flat block values
    pos = [spmv.node_block_positions(spmv.csr_to_device(lv["K"], "cpu", np.float32)).numpy()
           for lv in levels]

    mhat, base = [None] * top, [None] * top
    for l in range(top, 0, -1):
        K_f, K_c = levels[l]["K"], levels[l - 1]["K"]
        free_c = np.asarray(levels[l - 1]["free"]).reshape(-1)
        pidx, pw = _prolongation_rows(levels[l]["P"])
        rows_f = np.repeat(np.arange(K_f.shape[0], dtype=np.int64), np.diff(K_f.indptr))
        cols_f = K_f.indices.astype(np.int64)
        t = np.arange(K_f.nnz, dtype=np.int64)
        rM, cM, vM = [], [], []
        for a in range(2):
            for b in range(2):
                ci, cj = pidx[rows_f, a], pidx[cols_f, b]
                wgt = pw[rows_f, a] * pw[cols_f, b]
                keep = (wgt != 0.0) & free_c[ci] & free_c[cj]
                kc = spmv.csr_lookup(K_c, ci[keep], cj[keep])
                assert (kc >= 0).all(), "the Galerkin pattern is not the coarse pattern"
                rM.append(pos[l - 1][kc])
                cM.append(pos[l][t[keep]])
                vM.append(wgt[keep])
        M = sp.coo_matrix((np.concatenate(vM), (np.concatenate(rM), np.concatenate(cM))),
                          shape=(n_vals[l - 1], n_vals[l])).tocsr()
        M.sum_duplicates()
        vf_el = np.zeros(n_vals[l])
        vf_el[pos[l]] = K_f.data
        vc_el = np.zeros(n_vals[l - 1])
        vc_el[pos[l - 1]] = K_c.data
        base[l - 1] = torch.as_tensor((vc_el - M @ vf_el).astype(np.float32), device=device)
        mhat[l - 1] = spmv.csr_to_device(M, device, np.float32)

    diag_blocks = []
    for l, lv in enumerate(levels):
        k = np.arange(lv["coords"].shape[0], dtype=np.int64)
        kk = spmv.csr_lookup(lv["K"], 2 * k, 2 * k)
        assert (kk >= 0).all(), "a node's diagonal block is missing"
        diag_blocks.append(torch.as_tensor(pos[l][kk] // 4, device=device))

    K0 = levels[0]["K"]
    free0 = np.asarray(levels[0]["free"]).reshape(-1)
    fmap0, n_free0 = asm.free_dof_map(free0)
    r0 = np.repeat(np.arange(K0.shape[0], dtype=np.int64), np.diff(K0.indptr))
    c0 = K0.indices.astype(np.int64)
    ff0 = free0[r0] & free0[c0]
    return TangentHierarchy(
        geom=g, dest=dest, mhat=mhat, base=base, diag_blocks=diag_blocks,
        d0_idx=torch.as_tensor(fmap0[r0[ff0]].astype(np.int64) * n_free0 + fmap0[c0[ff0]],
                               device=device),
        pos0_ff=torch.as_tensor(pos[0][ff0], device=device),
        n_free0=int(n_free0),
    )


def shard_tangent_hierarchy(th: TangentHierarchy, hier_sh: Hierarchy, group) -> TangentHierarchy:
    """The tangent tables for `hier_sh` (`shard_hierarchy_ell` of the
    elastic hierarchy): the fine scatter's destinations shifted by the
    rank's first block (other ranks' blocks and dropped entries past the
    slice's values, so dropped), every Galerkin value map row-sharded (JAX
    `multigrid.py:669-700`, the sharded Mhat chain)."""
    fine = hier_sh.levels[-1].sweep_op
    n_local = spmv.block_values(fine).numel()
    dest = th.dest - 4 * fine.entry0
    dest = torch.where((dest >= 0) & (dest < n_local), dest, n_local)
    return th._replace(dest=dest, mhat=[spmv.shard_rows(M, group) for M in th.mhat],
                       fine_counts=tuple(4 * c for c in group.objects(n_local // 4)))


def refresh_hierarchy(th: TangentHierarchy, hier: Hierarchy, d_fine: torch.Tensor,
                      shear: float, bulk: float, omega: float = 0.7) -> Hierarchy:
    """The hierarchy refreshed from the consistent tangent d_fine ((3, 3,
    n_int) f32, the fine level's points), on new tensors: `hier`, the
    elastic hierarchy, is read and never written.

    Every element's K_e(d) - K_e(d_elastic) is added into a copy of the
    fine elastic values (`solve.newton.refreshed_values`); each coarser
    level's values are Mhat times the level above's plus the static offset
    (one launch of K3's CSR kernel a level); each level's damped
    block-Jacobi constants come from its refreshed diagonal blocks
    (closed-form 2x2 inverse times omega), and the coarsest level's solve
    from the explicit inverse of its Jacobi-scaled free-free matrix, one
    f32 factorization (`torch.linalg`; NaN where it fails, which CG
    reports).  On a row-sharded hierarchy (`shard_tangent_hierarchy`) the
    scatter writes the rank's slice of the fine values and is gathered,
    each Galerkin value map runs its rows and gathers, and each level keeps
    its slice of the refreshed values: the whole values and the constants
    are the unsharded refresh's bit for bit."""
    from .newton import refreshed_values

    f32 = torch.float32
    g = th.geom
    device = d_fine.device
    d_el = elastic_tangent_lanes(shear, bulk, g.n_int, f32, device)
    ke = asm.element_stiffness(g, d_fine - d_el).permute(2, 0, 1)
    top = len(hier.levels) - 1
    vals = [None] * (top + 1)
    fine = hier.levels[top].sweep_op
    vals[top] = refreshed_values(spmv.block_values(fine).reshape(-1), ke, th.dest)
    if isinstance(fine, spmv.RowShard):
        vals[top] = fine.group.gather(vals[top], th.fine_counts)
    for l in range(top, 0, -1):
        vals[l - 1] = spmv.sp_matvec(th.mhat[l - 1], vals[l]) + th.base[l - 1]

    eye = torch.eye(2, dtype=f32, device=device)
    levels = []
    for l, lev in enumerate(hier.levels):
        own = vals[l]
        if isinstance(lev.sweep_op, spmv.RowShard):  # the rank's slice of the values
            e0 = 4 * lev.sweep_op.entry0
            own = own[e0:e0 + spmv.block_values(lev.sweep_op).numel()]
        blocks = spmv.with_block_values(lev.sweep_op, own.reshape(-1, 4))
        free2 = lev.free.reshape(-1, 2)
        b = vals[l].reshape(-1, 4)[th.diag_blocks[l]].reshape(-1, 2, 2)
        b = torch.where(free2[:, :, None] & free2[:, None, :], b, torch.zeros_like(b))
        b = b + eye * (~free2).to(f32)[:, :, None]
        a_, b_, c_, d_ = b[:, 0, 0], b[:, 0, 1], b[:, 1, 0], b[:, 1, 1]
        det = a_ * d_ - b_ * c_
        i00, i01, i10, i11 = d_ / det * omega, -b_ / det * omega, -c_ / det * omega, a_ / det * omega
        levels.append(lev._replace(
            op=None if lev.op is None else blocks,
            sweep_op=blocks,
            inv=torch.stack([torch.stack([i00, i01], -1), torch.stack([i10, i11], -1)], -2),
            aux=lev.aux._replace(msf=torch.stack([i00, i11], 1).reshape(-1),
                                 mpr=torch.stack([i01, i10], 1).reshape(-1)),
        ))

    n0 = th.n_free0
    K0 = torch.zeros(n0 * n0, dtype=f32, device=device)
    K0[th.d0_idx] = vals[0][th.pos0_ff]
    K0 = K0.reshape(n0, n0)
    dsc = torch.rsqrt(torch.diagonal(K0))
    L0, info = torch.linalg.cholesky_ex(K0 * dsc[:, None] * dsc[None, :])
    Ki = torch.cholesky_solve(torch.eye(n0, dtype=f32, device=device), L0)
    Ki = torch.where(info == 0, Ki, torch.full_like(Ki, float("nan"))) * dsc[:, None] * dsc[None, :]
    return Hierarchy(levels=levels, inv0=Ki, free_idx0=hier.free_idx0)


def tangent_vcycle(th: TangentHierarchy, hier: Hierarchy, d_fine: torch.Tensor,
                   shear: float, bulk: float, nu=2, omega: float = 0.7):
    """The tangent refresh of one Newton iteration (`tangent_vcycle`, JAX
    `multigrid.py:623`) -> (CG operator v -> K_t v, V-cycle r -> z): K3's
    product on the refreshed fine blocks and `make_vcycle_ell` over the
    refreshed levels (`refresh_hierarchy`: K4 sweeps, K3 transfers)."""
    refreshed = refresh_hierarchy(th, hier, d_fine, shear, bulk, omega)
    fine = refreshed.levels[-1].op
    return (lambda v: spmv.sp_matvec(fine, v)), make_vcycle_ell(refreshed, nu=nu)
