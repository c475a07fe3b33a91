"""Element-batched assembly on tensors, lane-major layout.

Port of `fem_elastoplasticity_tpu/ops/assembly.py`.  The layout is kept
exactly, so the port's state maps one-to-one onto the JAX package's:

    B       (3, 2*n_p, n_int)   strain-displacement blocks
    weight  (n_int,)            |det J| * w_q
    edofs   (n_e, 2*n_p)        global DOF indices (2*node + component)

Integration points run element-major, quadrature-minor, and the element
count is padded so n_int is a multiple of LANE_PAD (896 points for the 887
tsx elements).  Padding points have zero B and zero weight and stay inert.

Every nodal accumulation is a gather over a map built on the host, summed
in a fixed order, in place of a scatter-add: a CUDA scatter-add uses
atomics, whose order changes from run to run and would move the f32 dense
tangent in its last bits.  With gathers, two runs on the card give the same
Newton trajectory bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .elements import ReferenceElement, SurfaceElement

LANE_PAD = 128


def _grouped_gather(keys: np.ndarray, src: np.ndarray, pad: int, n_rows: Optional[int] = None):
    """Group `src` positions by `keys` into a padded (rows, K) index table.

    Row r lists, in ascending `src` order, the positions whose key is the
    r-th key (`n_rows` given: key r itself, rows without positions are all
    padding).  Padding entries hold `pad`, the index of an appended zero.
    Returns (row_keys, table) as int64 numpy arrays.
    """
    order = np.lexsort((src, keys))
    keys_s, src_s = keys[order], src[order]
    if n_rows is None:
        row_keys, row_of = np.unique(keys_s, return_inverse=True)
    else:
        row_keys, row_of = np.arange(n_rows, dtype=np.int64), keys_s
    counts = np.bincount(row_of, minlength=row_keys.size)
    table = np.full((row_keys.size, max(int(counts.max(initial=0)), 1)), pad, np.int64)
    starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
    table[row_of, np.arange(src_s.size) - starts[row_of]] = src_s
    return row_keys.astype(np.int64), table


def _gather_sum(flat: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """sum_k flat_ext[table[:, k]] with flat_ext = flat plus one trailing zero."""
    ext = torch.cat([flat, flat.new_zeros(1)])
    return ext[table].sum(dim=1)


def _gather_fold(flat: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """`_gather_sum` as a left fold over the table's columns, from zero:
    ((0 + a_0) + a_1) + ...  The JAX package's scatter-add applies a
    destination's updates one after another in this order, so the fold
    reproduces its rounding; trailing padding adds exact zeros.  A (B, N)
    `flat` folds each member's row the same way."""
    ext = torch.cat([flat, flat.new_zeros(*flat.shape[:-1], 1)], dim=-1)
    acc = flat.new_zeros(*flat.shape[:-1], table.shape[0])
    for k in range(table.shape[1]):
        acc = acc + ext[..., table[:, k]]
    return acc


def _gather_sum_members(flat: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """`_gather_sum` of each row of a (B, N) `flat`."""
    ext = torch.cat([flat, flat.new_zeros(flat.shape[0], 1)], dim=1)
    return ext[:, table].sum(dim=-1)


class Geometry(NamedTuple):
    """Per-element quadrature geometry.

    B:        (3, 2*n_p, n_int) lane-major strain-displacement blocks
    weight:   (n_int,) quadrature weights including |det J| (0 on padding)
    edofs:    (n_e, 2*n_p) int64 global DOF indices, padding included
    gmap:     (2*n_n, K) int64 — for each DOF, the flat positions in the
              (2*n_p, n_e) per-element force array that accumulate into it,
              padded with the position of an appended zero
    n_nodes, n_q, n_real: mesh node count, points per element, real
              (non-padding) element count
    """

    B: torch.Tensor
    weight: torch.Tensor
    edofs: torch.Tensor
    gmap: torch.Tensor
    n_nodes: int
    n_q: int
    n_real: int

    @property
    def n_elems(self) -> int:  # including padding
        return self.edofs.shape[0]

    @property
    def n_int(self) -> int:
        return self.B.shape[2]

    @property
    def n_p2(self) -> int:
        return self.B.shape[1]

    @property
    def edofs_t(self) -> torch.Tensor:
        return self.edofs.T

    def to(self, dtype: torch.dtype) -> "Geometry":
        """The same geometry with B and weight rounded to `dtype`."""
        return self._replace(B=self.B.to(dtype), weight=self.weight.to(dtype))


def element_dofs(elems: np.ndarray) -> np.ndarray:
    """(n_e, n_p) node indices -> (n_e, 2*n_p) interleaved DOF indices."""
    e = np.asarray(elems, np.int64)
    return np.stack([2 * e, 2 * e + 1], axis=-1).reshape(e.shape[0], -1)


def dof_gather_map(edofs: np.ndarray, n_real: int, n_dofs: int) -> np.ndarray:
    """Padded per-DOF lists of force slots, (n_dofs, K) int64.

    Slot (k, e) of the (2*n_p, n_e) force array sits at k*n_e + e.  Only
    real elements contribute; padding rows point at the zero slot.
    """
    n_e, n_p2 = edofs.shape
    ks, es = np.meshgrid(np.arange(n_p2), np.arange(n_real), indexing="ij")
    pos = (ks * n_e + es).reshape(-1)
    dofs = np.asarray(edofs, np.int64)[:n_real].T.reshape(-1)
    _, table = _grouped_gather(dofs, pos, n_p2 * n_e, n_rows=n_dofs)
    return table


def make_geometry(B, weight, edofs, n_nodes: int, n_q: int, n_real: int) -> Geometry:
    """Geometry from its arrays; builds the DOF gather map on the host."""
    if isinstance(edofs, torch.Tensor):
        edofs = edofs.cpu().numpy()
    edofs_np = np.array(edofs, np.int64)
    gmap = dof_gather_map(edofs_np, n_real, 2 * n_nodes)
    return Geometry(
        B=B, weight=weight,
        edofs=torch.as_tensor(edofs_np, device=B.device),
        gmap=torch.as_tensor(gmap, device=B.device),
        n_nodes=int(n_nodes), n_q=int(n_q), n_real=int(n_real),
    )


def compute_geometry(
    coords: torch.Tensor, elems: np.ndarray, ref: ReferenceElement, pad_to: int = LANE_PAD,
    like: Optional[Geometry] = None,
) -> Geometry:
    """Jacobians, physical gradients, B blocks and weights for all elements.

    J = dN^T x_e, dphi = J^{-1} dN, weight = |det J| * w_q, in the dtype and
    on the device of `coords`.  Elements are zero-padded to a lane multiple.

    `like`: a Geometry of the same mesh and element, whose edofs and gather
    map are taken as they are: the call then does no host work, `elems` may
    be an index tensor on coords' device, and where ref's `dN` and `w` are
    tensors there too (an `ElementTables`), it launches only device work
    (the elastic assembly sweep captures it in a CUDA graph).
    """
    dtype, device = coords.dtype, coords.device
    if like is None:
        elems = np.asarray(elems, np.int64)
    n_e = elems.shape[0]
    xe = coords[torch.as_tensor(elems, device=device)]  # (n_e, n_p, 2)
    dN = torch.as_tensor(ref.dN, dtype=dtype, device=device)  # (n_q, n_p, 2)
    n_q, n_p, _ = dN.shape

    J = torch.einsum("qpi,epj->eqij", dN, xe)
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    inv = (
        torch.stack(
            [
                torch.stack([J[..., 1, 1], -J[..., 0, 1]], dim=-1),
                torch.stack([-J[..., 1, 0], J[..., 0, 0]], dim=-1),
            ],
            dim=-2,
        )
        / det[..., None, None]
    )
    dphi = torch.einsum("eqij,qpj->eqpi", inv, dN)
    weight = det.abs() * torch.as_tensor(ref.w, dtype=dtype, device=device)[None, :]

    dx = dphi[..., 0].permute(2, 0, 1).reshape(n_p, -1)  # (n_p, n_int)
    dy = dphi[..., 1].permute(2, 0, 1).reshape(n_p, -1)
    zero = torch.zeros_like(dx)
    row0 = torch.stack([dx, zero], dim=1).reshape(2 * n_p, -1)
    row1 = torch.stack([zero, dy], dim=1).reshape(2 * n_p, -1)
    row2 = torch.stack([dy, dx], dim=1).reshape(2 * n_p, -1)
    B = torch.stack([row0, row1, row2], dim=0)  # (3, 2*n_p, n_int)
    w = weight.reshape(-1)

    n_e_total = n_e
    while (n_e_total * n_q) % pad_to != 0:
        n_e_total += 1
    pad_e = n_e_total - n_e
    if pad_e:
        B = torch.nn.functional.pad(B, (0, pad_e * n_q))
        w = torch.nn.functional.pad(w, (0, pad_e * n_q))
    if like is not None:
        return like._replace(B=B, weight=w)
    if pad_e:
        elems = np.pad(elems, ((0, pad_e), (0, 0)))
    return make_geometry(B, w, element_dofs(elems), coords.shape[0], n_q, n_e)


# ---------------------------------------------------------------------------
# strain / force / stiffness contractions (lane-major)
# ---------------------------------------------------------------------------
# Each contraction also takes a leading member axis over the shared geometry
# (a material ensemble: `parallel/ensemble.py`): u (B, 2*n_n), s3 and e
# (B, 3, n_int), d (B, 3, 3, n_int).  Each member's row is contracted in the
# single form's order.
def dof_values(geom: Geometry, u: torch.Tensor) -> torch.Tensor:
    """u (2*n_n,) -> per-integration-point DOF values (2*n_p, n_int);
    u (B, 2*n_n) -> (B, 2*n_p, n_int)."""
    ue = u[..., geom.edofs_t]  # (2*n_p, n_e)
    if geom.n_q == 1:
        return ue
    lead = ue.shape[:-2]
    return ue[..., None].expand(*lead, geom.n_p2, geom.n_elems, geom.n_q).reshape(
        *lead, geom.n_p2, -1)


def strains(geom: Geometry, u: torch.Tensor) -> torch.Tensor:
    """Total strain at integration points: (3, n_int), [e11, e22, 2e12]."""
    ui = dof_values(geom, u)
    if u.dim() == 2:
        return (geom.B * ui[:, None, :, :]).sum(dim=2)
    return (geom.B * ui[None, :, :]).sum(dim=1)


def internal_force(geom: Geometry, s3: torch.Tensor, group=None) -> torch.Tensor:
    """F = B^T (weight * s) accumulated to (2*n_n,).  s3: (3, n_int).
    `group` (a `parallel.sharding.ShardGroup`, the JAX package's
    `axis_name`): geom is this rank's element shard, and the nodal partial
    sums of the ranks are added in rank order (`ShardGroup.sum_ranks`)."""
    f = _internal_force(geom, s3)
    return f if group is None else group.sum_ranks(f)


def _internal_force(geom: Geometry, s3: torch.Tensor) -> torch.Tensor:
    ws = geom.weight[None, :] * s3
    if s3.dim() == 3:
        n_b = s3.shape[0]
        fk = (geom.B * ws[:, :, None, :]).sum(dim=1)  # (B, 2*n_p, n_int)
        if geom.n_q > 1:
            fk = fk.reshape(n_b, geom.n_p2, geom.n_elems, geom.n_q).sum(dim=-1)
        return _gather_sum_members(fk.reshape(n_b, -1), geom.gmap)
    fk = (geom.B * ws[:, None, :]).sum(dim=0)  # (2*n_p, n_int)
    if geom.n_q > 1:
        fk = fk.reshape(geom.n_p2, geom.n_elems, geom.n_q).sum(dim=-1)
    return _gather_sum(fk.reshape(-1), geom.gmap)


def apply_tangent(d: torch.Tensor, e: torch.Tensor) -> torch.Tensor:
    """s = D e per integration point: d (3, 3, n), e (3, n) -> (3, n)."""
    if d.dim() == 4:
        return (d * e[:, None, :, :]).sum(dim=2)
    return (d * e[None, :, :]).sum(dim=1)


def tangent_matvec(geom: Geometry, d: torch.Tensor, v: torch.Tensor,
                   group=None) -> torch.Tensor:
    """Matrix-free K v: gather -> strain -> D -> B^T -> gather-sum; with
    `group` over the element shards (`internal_force`)."""
    return internal_force(geom, apply_tangent(d, strains(geom, v)), group)


def element_stiffness(geom: Geometry, d: torch.Tensor) -> torch.Tensor:
    """Per-element stiffness K_e = sum_q w_q B^T D B: (2*n_p, 2*n_p, n_e).

    d: (3, 3, n_int) material tangent at integration points; (B, 3, 3,
    n_int) gives (B, 2*n_p, 2*n_p, n_e).
    """
    wd = geom.weight[None, None, :] * d
    if d.dim() == 4:
        n_b = d.shape[0]
        T = (geom.B[None, :, None, :, :] * wd[:, :, :, None, :]).sum(dim=1)
        ke = (T[:, :, :, None, :] * geom.B[None, :, None, :, :]).sum(dim=1)
        if geom.n_q > 1:
            ke = ke.reshape(n_b, geom.n_p2, geom.n_p2, geom.n_elems, geom.n_q).sum(dim=-1)
        return ke
    T = (geom.B[:, None, :, :] * wd[:, :, None, :]).sum(dim=0)
    ke = (T[:, :, None, :] * geom.B[:, None, :, :]).sum(dim=0)
    if geom.n_q > 1:
        ke = ke.reshape(geom.n_p2, geom.n_p2, geom.n_elems, geom.n_q).sum(dim=-1)
    return ke


# ---------------------------------------------------------------------------
# dense assembly on the free-DOF subspace
# ---------------------------------------------------------------------------
def free_dof_map(free_mask: np.ndarray) -> Tuple[np.ndarray, int]:
    """free_mask (n_n, 2) bool -> (map (2*n_n,) int32, n_free).

    Maps each global DOF to its position among free DOFs, or to n_free
    (a trash slot) if constrained.
    """
    flat = np.asarray(free_mask).reshape(-1)
    n_free = int(flat.sum())
    m = np.full(flat.shape, n_free, dtype=np.int32)
    m[flat] = np.arange(n_free, dtype=np.int32)
    return m, n_free


class DensePlan(NamedTuple):
    """Host-built gather plan for `assemble_dense_free`.

    table:  (n_t, K) positions in the flat element-stiffness array (plus
            an appended zero) that sum into each nonzero of K_free
    target: (n_t,) flat position of that nonzero in (n_free, n_free)
    n_free: free DOF count
    """

    table: torch.Tensor
    target: torch.Tensor
    n_free: int


def dense_free_plan(geom: Geometry, fmap: np.ndarray, n_free: int) -> DensePlan:
    """Plan the scatter of element matrices into the dense free-DOF matrix.

    Entries on constrained DOFs are left out, as the JAX package's trash
    row/column is sliced away; padding elements carry zero matrices and
    are skipped.
    """
    edofs = np.asarray(geom.edofs.cpu(), np.int64)
    n_e, n_p2 = edofs.shape
    fd = np.asarray(fmap, np.int64)[edofs[: geom.n_real]]  # (n_real, 2n_p)
    i, j, e = np.meshgrid(
        np.arange(n_p2), np.arange(n_p2), np.arange(geom.n_real), indexing="ij"
    )
    src = (i * (n_p2 * n_e) + j * n_e + e).reshape(-1)
    ri, rj = fd[e, i].reshape(-1), fd[e, j].reshape(-1)
    keep = (ri < n_free) & (rj < n_free)
    target, table = _grouped_gather(
        ri[keep] * n_free + rj[keep], src[keep], n_p2 * n_p2 * n_e
    )
    device = geom.B.device
    return DensePlan(
        table=torch.as_tensor(table, device=device),
        target=torch.as_tensor(target, device=device),
        n_free=n_free,
    )


def assemble_dense_free(ke: torch.Tensor, plan: DensePlan) -> torch.Tensor:
    """Element matrices (2*n_p, 2*n_p, n_e) -> dense (n_free, n_free).

    Each entry's contributions are added in ascending (row slot, column
    slot, element) order, the order of the JAX package's scatter-add, so
    the f32 matrix equals the JAX package's bit for bit on the CPU.
    (B, 2*n_p, 2*n_p, n_e) gives (B, n_free, n_free), each member's matrix
    bitwise its single assembly."""
    if ke.dim() == 4:
        n_b = ke.shape[0]
        K = ke.new_zeros(n_b, plan.n_free * plan.n_free)
        K[:, plan.target] = _gather_fold(ke.reshape(n_b, -1), plan.table)
        return K.reshape(n_b, plan.n_free, plan.n_free)
    K = ke.new_zeros(plan.n_free * plan.n_free)
    K[plan.target] = _gather_fold(ke.reshape(-1), plan.table)
    return K.reshape(plan.n_free, plan.n_free)


# ---------------------------------------------------------------------------
# load vectors
# ---------------------------------------------------------------------------
def volume_force_vector(geom: Geometry, ref: ReferenceElement, f: torch.Tensor) -> torch.Tensor:
    """Volume load vector, the scatter of N^T (w f), (2*n_n,)
    (`get_vector_volume`, `Elasticity2D/pythonFEM.py:246-292`).  f: (2,)
    constant body force or (2, n_int) field.  Summed by the geometry's DOF
    gather map in a fixed order."""
    dtype, device = geom.B.dtype, geom.B.device
    N = torch.as_tensor(ref.N, dtype=dtype, device=device)  # (n_q, n_p)
    f = torch.as_tensor(f, dtype=dtype, device=device)
    if f.ndim == 1:
        f = f[:, None].expand(2, geom.n_int)
    wf = geom.weight[None, :] * f  # (2, n_int)
    n_p = geom.n_p2 // 2
    Nt = N.T[:, None, :].expand(n_p, geom.n_elems, geom.n_q).reshape(n_p, -1)
    vals = Nt[:, None, :] * wf[None, :, :]  # (n_p, 2, n_int): row 2p + c
    vals = vals.reshape(geom.n_p2, geom.n_elems, geom.n_q).sum(-1)
    return _gather_sum(vals.reshape(-1), geom.gmap)


def traction_force_vector(coords: torch.Tensor, edges: np.ndarray, surf: SurfaceElement,
                          t, n_nodes: int) -> torch.Tensor:
    """Traction load vector over boundary edges, (2*n_n,)
    (`get_vector_traction`, `Elasticity2D/pythonFEM.py:295-364`), with its
    x-projected line measure |j11| (right for the axis-aligned traction
    faces of the benchmarks).  t: (2,) traction.  Summed by a gather map
    built here on the host, in a fixed order."""
    dtype, device = coords.dtype, coords.device
    edges = np.asarray(edges, np.int64)
    xe = coords[torch.as_tensor(edges, device=device)]  # (n_s, n_p_s, 2)
    N = torch.as_tensor(surf.N, dtype=dtype, device=device)  # (n_q, n_p_s)
    dN = torch.as_tensor(surf.dN, dtype=dtype, device=device)
    j11 = torch.einsum("qp,sp->sq", dN, xe[..., 0])
    w = j11.abs() * torch.as_tensor(surf.w, dtype=dtype, device=device)[None, :]
    t = torch.as_tensor(t, dtype=dtype, device=device).expand(edges.shape[0], surf.n_q, 2)
    vals = torch.einsum("qp,sq,sqc->spc", N, w, t)
    dofs = element_dofs(edges).reshape(-1)
    _, table = _grouped_gather(dofs, np.arange(dofs.size), dofs.size, n_rows=2 * n_nodes)
    return _gather_sum(vals.reshape(-1), torch.as_tensor(table, device=device))


def pressure_traction_vector(coords: torch.Tensor, edges: np.ndarray, surf: SurfaceElement,
                             p: float, n_nodes: int) -> torch.Tensor:
    """Normal pressure load on (possibly curved) boundary edges, (2*n_n,)
    (JAX `ops/assembly.py:370`): t = -p n_out at each quadrature point,
    with the arc-length measure sqrt(j11^2 + j12^2) and the outward normal
    (t_y, -t_x) / |t| of the edge as its element orients it (a CCW element
    keeps the domain on its left).  `edges` from `mesh.boundary
    .boundary_edges` (P1/P2/P4).  Each DOF's contributions are added one
    after another in the edges' order, from zero, as the JAX package's
    segment sum adds them (`_gather_fold`)."""
    dtype, device = coords.dtype, coords.device
    edges = np.asarray(edges, np.int64)
    xe = coords[torch.as_tensor(edges, device=device)]  # (n_s, n_p_s, 2)
    N = torch.as_tensor(surf.N, dtype=dtype, device=device)  # (n_q, n_p_s)
    dN = torch.as_tensor(surf.dN, dtype=dtype, device=device)
    tx = torch.einsum("qp,sp->sq", dN, xe[..., 0])
    ty = torch.einsum("qp,sp->sq", dN, xe[..., 1])
    arc = torch.sqrt(tx * tx + ty * ty)
    w = arc * torch.as_tensor(surf.w, dtype=dtype, device=device)[None, :]
    p = torch.as_tensor(p, dtype=dtype, device=device)
    # the traction of the pressure on the domain: -p times the outward normal
    t = torch.stack([-p * ty / arc, p * tx / arc], dim=-1)  # (n_s, n_q, 2)
    vals = torch.einsum("qp,sq,sqc->spc", N, w, t)
    dofs = element_dofs(edges).reshape(-1)
    _, table = _grouped_gather(dofs, np.arange(dofs.size), dofs.size, n_rows=2 * n_nodes)
    return _gather_fold(vals.reshape(-1), torch.as_tensor(table, device=device))


# ---------------------------------------------------------------------------
# integration-point -> node projection
# ---------------------------------------------------------------------------
def _node_slot_table(geom: Geometry) -> np.ndarray:
    """Padded per-node lists of the (local node, element) slots of the real
    elements, flat positions p * n_elems + e in ascending order (the JAX
    package's segment order), (n_n, K) int64; padding holds n_p * n_elems."""
    edofs = np.asarray(geom.edofs.cpu(), np.int64)
    n_e, n_p = edofs.shape[0], geom.n_p2 // 2
    nodes = edofs[: geom.n_real, ::2].T // 2  # (n_p, n_real)
    ks, es = np.meshgrid(np.arange(n_p), np.arange(geom.n_real), indexing="ij")
    pos = (ks * n_e + es).reshape(-1)
    _, table = _grouped_gather(nodes.reshape(-1), pos, n_p * n_e, n_rows=geom.n_nodes)
    return table


def node_gather_map(geom: Geometry) -> torch.Tensor:
    """Padded per-node lists of the real elements that touch each node,
    (n_n, K) int64 on geom's device; padding holds n_elems, the index of
    an appended zero.  Host-built once, for `project_to_nodes`."""
    n_e, n_p = geom.n_elems, geom.n_p2 // 2
    table = _node_slot_table(geom)
    table = np.where(table == n_p * n_e, n_e, table % n_e)
    return torch.as_tensor(table, device=geom.B.device)


def node_slot_map(geom: Geometry) -> torch.Tensor:
    """`_node_slot_table` on geom's device: each node's (local node,
    element) slots, padding at the index of an appended zero.  Host-built
    once, for `node_block_diagonal`."""
    return torch.as_tensor(_node_slot_table(geom), device=geom.B.device)


def node_block_diagonal(
    geom: Geometry, d: torch.Tensor, smap: Optional[torch.Tensor] = None, group=None
) -> torch.Tensor:
    """2x2 nodal diagonal blocks of K for block-Jacobi preconditioning,
    (n_n, 2, 2), without forming element matrices
    (`assembly.node_block_diagonal`).  Each node's blocks are summed by a
    gather in a fixed order in place of the JAX package's segment sum.
    d: (3, 3, n_int) material tangent; smap: `node_slot_map(geom)`, built
    here when not given; `group`: the element shards' blocks added in rank
    order (`internal_force`)."""
    out = _node_block_diagonal(geom, d, node_slot_map(geom) if smap is None else smap)
    return out if group is None else group.sum_ranks(out)


def _node_block_diagonal(geom: Geometry, d: torch.Tensor, smap: torch.Tensor) -> torch.Tensor:
    n_p = geom.n_p2 // 2
    wd = geom.weight[None, None, :] * d
    if d.dim() == 4:  # (B, 3, 3, n_int) -> (B, n_n, 2, 2)
        n_b = d.shape[0]
        T = (geom.B[None, :, None, :, :] * wd[:, :, :, None, :]).sum(dim=1)
        T4 = T.reshape(n_b, 3, n_p, 2, -1)
        B4 = geom.B.reshape(1, 3, n_p, 2, -1)
        diag = (T4[:, :, :, :, None, :] * B4[:, :, :, None, :, :]).sum(dim=1)
        if geom.n_q > 1:
            diag = diag.reshape(n_b, n_p, 2, 2, geom.n_elems, geom.n_q).sum(dim=-1)
        flat = diag.permute(0, 1, 4, 2, 3).reshape(n_b, -1, 4)
        ext = torch.cat([flat, flat.new_zeros(n_b, 1, 4)], dim=1)
        return ext[:, smap].sum(dim=2).reshape(n_b, -1, 2, 2)
    T = (geom.B[:, None, :, :] * wd[:, :, None, :]).sum(dim=0)  # (3, 2n_p, n)
    T4 = T.reshape(3, n_p, 2, -1)
    B4 = geom.B.reshape(3, n_p, 2, -1)
    # diag[p, i, j, n] = sum_b T[b, 2p+i, n] * B[b, 2p+j, n]
    diag = (T4[:, :, :, None, :] * B4[:, :, None, :, :]).sum(dim=0)
    if geom.n_q > 1:
        diag = diag.reshape(n_p, 2, 2, geom.n_elems, geom.n_q).sum(dim=-1)
    flat = diag.permute(0, 3, 1, 2).reshape(-1, 4)  # row p * n_elems + e
    ext = torch.cat([flat, flat.new_zeros(1, 4)])
    return ext[smap].sum(dim=1).reshape(-1, 2, 2)


def project_to_nodes(geom: Geometry, q_int: torch.Tensor, nmap: torch.Tensor) -> torch.Tensor:
    """Volume-weighted projection of a point field to nodes: (n_n,).

    Nodal value = sum over the elements touching the node of the
    element's sum_q w q, over the same sum of w (the reference's
    `transform`, `tsx-tunnel/pythonFEM.py:1160-1216`).  q_int: (n_int,);
    nmap: `node_gather_map(geom)`.  A gather with a fixed summation order
    in place of the JAX package's segment sum: an `index_add_` on the card
    uses atomics and would move the footing's pressure in its last bits
    from run to run.
    """
    wq = (geom.weight * q_int).reshape(geom.n_elems, geom.n_q).sum(-1)  # (n_e,)
    wsum = geom.weight.reshape(geom.n_elems, geom.n_q).sum(-1)
    return _gather_sum(wq, nmap) / _gather_sum(wsum, nmap)


# ---------------------------------------------------------------------------
# low-rank plastic tangent correction (Woodbury solve)
# ---------------------------------------------------------------------------
def plastic_slots(ind_p: torch.Tensor, p_max: int):
    """Static-size compaction of the plastic integration-point set.

    Slot s holds the index of the (s+1)-th plastic point in ascending
    order; slots past the plastic count are invalid and point at 0.
    Returns (idx (p_max,) int64, valid (p_max,) bool); ind_p (B, n) gives
    (B, p_max) each.
    """
    if ind_p.dim() == 2:
        cnt = torch.cumsum(ind_p.to(torch.int64), dim=1)
        wanted = torch.arange(1, p_max + 1, dtype=torch.int64, device=ind_p.device)
        idx = torch.searchsorted(cnt, wanted.expand(ind_p.shape[0], p_max).contiguous(),
                                 side="left")
        valid = torch.arange(p_max, device=ind_p.device)[None, :] < cnt[:, -1:]
        return torch.where(valid, idx, torch.zeros_like(idx)), valid
    cnt = torch.cumsum(ind_p.to(torch.int64), dim=0)
    wanted = torch.arange(1, p_max + 1, dtype=torch.int64, device=ind_p.device)
    idx = torch.searchsorted(cnt, wanted, side="left")
    valid = torch.arange(p_max, device=ind_p.device) < cnt[-1]
    idx = torch.where(valid, idx, torch.zeros_like(idx))
    return idx, valid


def plastic_correction_gather(
    geom: Geometry, delta: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor
):
    """Gather (B, w*delta, dofs) at the plastic slot set.

    delta: (3, 3, n_int) tangent deviation from elastic (d - d_elastic).
    Returns (Bp (3, 2n_p, P), wdelta (3, 3, P), edp (2n_p, P)); invalid
    slots get zero wdelta, which makes them inert.  delta (B, 3, 3, n_int)
    with idx and valid (B, P) gives each with a leading member axis.
    """
    if delta.dim() == 4:
        n_b, P = idx.shape
        Bp = geom.B[:, :, idx].permute(2, 0, 1, 3)  # (B, 3, 2n_p, P)
        w = torch.where(valid, geom.weight[idx], torch.zeros((), dtype=geom.weight.dtype,
                                                              device=idx.device))
        wdelta = delta.gather(-1, idx[:, None, None, :].expand(n_b, 3, 3, P)) * w[:, None, None, :]
        edp = geom.edofs_t[:, idx // geom.n_q].permute(1, 0, 2)  # (B, 2n_p, P)
        return Bp, wdelta, edp
    Bp = geom.B[:, :, idx]
    w = torch.where(valid, geom.weight[idx], torch.zeros((), dtype=geom.weight.dtype,
                                                          device=idx.device))
    wdelta = delta[:, :, idx] * w
    edp = geom.edofs_t[:, idx // geom.n_q]
    return Bp, wdelta, edp


def plastic_correction_apply(
    Bp: torch.Tensor, wdelta: torch.Tensor, edp: torch.Tensor, n_dofs: int, v: torch.Tensor
) -> torch.Tensor:
    """(K_tangent - K_elastic) v over the gathered plastic slots.

    The contraction B^T (w delta) B v of `tangent_matvec` restricted to the
    slot set: gather v at the slots' element DOFs as (x, y) node pairs,
    strain, apply the tangent deviation, and sum B^T back into the nodes.
    Points of neighbouring elements share nodes; the accumulating
    `index_put_` adds each node's contributions in a fixed order (on the
    card it sorts the destinations; an atomic `index_add_` would add them
    in an order that changes from run to run).  Bp (3, 2n_p, P), wdelta
    (3, 3, P), edp (2n_p, P): `plastic_correction_gather`.
    """
    n2p, P = edp.shape
    en = edp[0::2] // 2  # (n_p, P) node ids
    ue = v.reshape(-1, 2)[en]  # (n_p, P, 2)
    ue = ue.permute(0, 2, 1).reshape(n2p, P)  # interleaved (2n_p, P)
    e3 = (Bp * ue[None, :, :]).sum(dim=1)  # (3, P)
    s3 = (wdelta * e3[None, :, :]).sum(dim=1)  # (3, P)
    fk = (Bp * s3[:, None, :]).sum(dim=0)  # (2n_p, P)
    fk2 = fk.reshape(n2p // 2, 2, P).permute(0, 2, 1).reshape(-1, 2)
    out = v.new_zeros((n_dofs // 2, 2))
    out.index_put_((en.reshape(-1),), fk2, accumulate=True)
    return out.reshape(-1)
