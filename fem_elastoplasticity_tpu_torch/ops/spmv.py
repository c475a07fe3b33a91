"""Assembled sparse operators: host CSR and ELL assembly, the node layouts,
and the kernels K1, K3, K4, K5 and K6.

Port of `fem_elastoplasticity_tpu/ops/spmv.py`.

Host half (NumPy/SciPy, copies of the JAX package's setup code):

* `rcm_node_order`, `permute_mesh`, `host_element_stiffness`,
  `assemble_csr`, `apply_bc_csr`, `diag_blocks_csr`, `csr_lookup`: the
  locality ordering and the elastic stiffness as a scipy CSR;
* `build_elastic_csr` is `build_ell_elastic` (`spmv.py:304-331`) up to its
  CSR, `build_residual_csr` is `build_residual_slot_df`
  (`spmv.py:1005-1085`) up to its CSR matrices;
* `element_corr_dest` (`spmv.py:610-636`) gives, per element, the index
  into the CSR value array of each entry of its stiffness block;
* `build_ell` is `build_ell` / `build_ell_df` (`spmv.py:178`, `:787`) with
  the JAX package's row-degree cap, in slices of 32 rows each at its own
  width, without the 128-lane window, and with the entries past the cap
  as a tail that the same thread walks.

The slot packing (`_slot_pack`, `_ragged_pack`, `slot_csr_positions`,
`pack_slot_bf16`'s byte-wide lane index) is TPU tile geometry and is not
carried over: the card takes the CSR as it is.

Device half:

* `csr_matvec` replaces `sp_matvec_df` / `slot_matvec_df` (`spmv.py:975`,
  `:1370`) for f64 values, kernel K1, and `slot_matvec` for f32 values,
  K3's CSR kernel: one template in `csrc/csr_spmv.cu`, over the row blocks
  `row_blocks` cuts once per structure (entries staged coalesced, each row
  summed in CSR order).  K1 computes the residual's G u and S s; K3's CSR
  kernel applies the footing tangent multigrid's Galerkin value maps
  (`solve.multigrid.refresh_hierarchy`) and the high-order f32 heads of G
  and S (rectangular);
* `node_block_matvec` replaces `slot_matvec` (`spmv.py:1431`) on a square
  operator, K3's product (the CG operator, the criterion, the predictor):
  the f32 `NodeBlockMatrix` the sweep reads, through the sweep kernel's
  third epilogue (`node_block_spmv` in `csrc/block_jacobi_sweep.cu`);
  `node_block_positions` maps a CSR entry to its place in the blocks,
  which the tangent refresh's table goes through (`node_block_dest`);
* `transfer` replaces `slot_matvec` on the multigrid transfers (its
  `_rslot_kernel` for R, `spmv.py:1455`), K3's transfers: a `NodeTransfer`
  (P or R = P^T, a node-level operator times I_2) in `csrc/node_transfer.cu`,
  with the V-cycle's mask, or mask and add, fused in;
* `block_jacobi_sweep` replaces `slot_sweep` / `slot_sweep_b`
  (`spmv.py:1610`, `:1699`), kernel K4, on a `NodeBlockMatrix` (the 2x2
  node-block layout `node_blocks` builds from a level's CSR) with f32
  values, and `slot_sweep_pk` (`spmv.py:1936`), kernel K5, on one with
  bf16 values; both are in `csrc/block_jacobi_sweep.cu`, with `sweep_aux`
  for `build_sweep_aux` (`spmv.py:1583`); `packed_matvec` replaces
  `slot_matvec_pk` (`spmv.py:1909`) through K5;
* `ell_matvec` replaces `ell_matvec` / `ell_matvec_df` (`spmv.py:417`,
  `:902`), kernel K6 `csrc/ell_spmv.cu` (f32 and f64), one launch a
  product, slots and tail;
* `sp_matvec` dispatches on the operator type, as `sp_matvec` /
  `sp_matvec_df` (`spmv.py:350`, `:975`) do: `CsrMatrix`,
  `NodeBlockMatrix` or `EllMatrix` (the JAX package's `SplitCols` S is
  one `EllMatrix` here), or a `RowShard` of one.

Row sharding (`ShardedMeta`, `shard_rows`, `_gather_rows`,
`_sharded_matvec` of `spmv.py:2015-2107`): `shard_rows` cuts an operator
into one rank's contiguous row slice with global columns, in the port's
own formats (CSR rows with their row blocks rebuilt, node rows of node
blocks and node transfers, ELL slices of 32 rows with their tails), and
`sp_matvec`, `block_jacobi_sweep` and `transfer` run the local rows and
gather them (`parallel.sharding.ShardGroup.gather`, a concatenation).  Each
row is summed as in the whole operator, so the bits do not change.  The
sweep on a slice is K4's split-z instance: its product reads z at global
columns, its update term the rank's own rows of z (`node_offset`).

On a CUDA tensor a wrapper launches its hand-written kernel; on a CPU
tensor it runs the plain PyTorch version beside it.  It never falls back
from one to the other.

`LAUNCHES` counts, per process, kernel launches ("csr_spmv_f64",
"csr_spmv_f32", "node_block_spmv", "node_transfer", "block_jacobi_sweep",
"block_jacobi_sweep_bf16", "ell_spmv_f32", "ell_spmv_f64") and calls
routed to a plain version (the same names with "_plain").  A run shows
that it went through the kernels by clearing the counts before it and
reading them after.
"""
from __future__ import annotations

import collections
import ctypes
import functools
import pathlib
from typing import NamedTuple, Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from .elements import ReferenceElement

_CSRC = pathlib.Path(__file__).parent / "csrc"
KERNEL_SOURCE = _CSRC / "csr_spmv.cu"
SWEEP_SOURCE = _CSRC / "block_jacobi_sweep.cu"
TRANSFER_SOURCE = _CSRC / "node_transfer.cu"
ELL_SOURCE = _CSRC / "ell_spmv.cu"
LAUNCHES: collections.Counter = collections.Counter()


class CsrMatrix(NamedTuple):
    """CSR matrix on one device: int32 indptr/indices, f64 or f32 values.

    The values are a field of their own so that the same structure can
    carry a new value array (`_replace(values=...)`): the refreshed tangent
    of every Newton iteration lives on the elastic operator's pattern.
    `row_blocks` is the CSR kernel's table of the structure (`row_blocks`),
    built by `csr_to_device`; it travels with `_replace(values=...)`."""

    indptr: torch.Tensor  # (n_rows + 1,) int32
    indices: torch.Tensor  # (nnz,) int32
    values: torch.Tensor  # (nnz,) float64 or float32
    shape: Tuple[int, int]
    row_blocks: Optional[torch.Tensor] = None  # (n_blocks + 1, 2) int32 (row, entry)

    @property
    def n_rows(self) -> int:
        return self.shape[0]


# the CSR kernel's row blocks: threads a block (and rows a block at most),
# entries a block holds (and stages in shared memory at a time), and the
# fewest blocks a smaller operator is cut into (two for each of the H100's
# 132 SMs); tuned on the P1, P4 and footing operators (PERF.md)
ROW_BLOCK_ROWS = 256
ROW_BLOCK_ENTRIES = 1024
ROW_BLOCK_MIN_BLOCKS = 264
# a matrix whose entries (value and index) take more than half the H100's
# 50 MB L2 is read with the evict-first hint, so that x stays in L2; a
# smaller one stays cached between products
STREAM_ENTRY_BYTES = 25 * 2**20


def row_blocks(indptr: np.ndarray) -> np.ndarray:
    """The CSR kernel's row blocks of a structure: (n_blocks + 1, 2) int32,
    block b's first row and first entry, and last (n_rows, nnz).  Each
    block is a run of consecutive rows, at most `ROW_BLOCK_ROWS` of them
    with at most `ROW_BLOCK_ENTRIES` entries together, or a single row with
    more.  A smaller operator takes fewer entries a block, down to
    `ROW_BLOCK_ROWS`, so that it still spreads over `ROW_BLOCK_MIN_BLOCKS`
    blocks.  Greedy, in row order, one search a block.  The blocking
    changes no row's sum."""
    indptr = np.asarray(indptr, np.int64)
    n = indptr.shape[0] - 1
    cap = min(ROW_BLOCK_ENTRIES, max(ROW_BLOCK_ROWS, -(-int(indptr[-1]) // ROW_BLOCK_MIN_BLOCKS)))
    starts = [0]
    r = 0
    while r < n:
        end = int(np.searchsorted(indptr, indptr[r] + cap, side="right")) - 1
        r = min(max(end, r + 1), r + ROW_BLOCK_ROWS)
        starts.append(r)
    return np.stack([starts, indptr[starts]], axis=1).astype(np.int32)


def csr_streams(A: CsrMatrix) -> bool:
    """Whether the CSR kernel reads A's entries with the evict-first hint:
    when they take more than `STREAM_ENTRY_BYTES`."""
    return A.values.numel() * (A.values.element_size() + 4) > STREAM_ENTRY_BYTES


def csr_to_device(A: sp.csr_matrix, device, dtype=np.float64) -> CsrMatrix:
    """Host scipy CSR -> `CsrMatrix` on `device`, values rounded to `dtype`,
    with the CSR kernel's row blocks.  Explicit zeros stay: the tangent
    refresh scatters into them."""
    A = sp.csr_matrix(A)
    A.sort_indices()
    # int32 structure: the level-5 G has 2.7 M rows and 11 M entries
    assert max(A.nnz + ROW_BLOCK_ENTRIES, *A.shape) < np.iinfo(np.int32).max, \
        "CSR too large for int32 indices"
    return CsrMatrix(
        indptr=torch.as_tensor(A.indptr.astype(np.int32), device=device),
        indices=torch.as_tensor(A.indices.astype(np.int32), device=device),
        values=torch.as_tensor(A.data.astype(dtype), device=device),
        shape=(int(A.shape[0]), int(A.shape[1])),
        row_blocks=torch.as_tensor(row_blocks(A.indptr), device=device),
    )


# ---------------------------------------------------------------------------
# host side: locality ordering and the elastic stiffness as CSR
# ---------------------------------------------------------------------------
def rcm_node_order(elems: np.ndarray, n_nodes: int) -> np.ndarray:
    """Reverse Cuthill-McKee node ordering from element connectivity.

    Returns `order` with order[k] = old node id placed at new position k.
    """
    from scipy.sparse.csgraph import reverse_cuthill_mckee

    elems = np.asarray(elems)
    n_p = elems.shape[1]
    rows, cols = [], []
    for a in range(n_p):
        for b in range(a + 1, n_p):
            rows.append(elems[:, a])
            cols.append(elems[:, b])
    i = np.concatenate(rows + cols)
    j = np.concatenate(cols + rows)
    adj = sp.coo_matrix(
        (np.ones(i.shape[0], np.int8), (i, j)), shape=(n_nodes, n_nodes)
    ).tocsr()
    return np.asarray(reverse_cuthill_mckee(adj, symmetric_mode=True))


def permute_mesh(coords: np.ndarray, elems: np.ndarray, order: np.ndarray):
    """Apply a node order: returns (coords', elems', new_of_old)."""
    n_n = coords.shape[0]
    new_of_old = np.empty(n_n, np.int64)
    new_of_old[order] = np.arange(n_n)
    return coords[order], new_of_old[np.asarray(elems)], new_of_old


def restore_reference_order(u: np.ndarray, ep: np.ndarray, new_of_old: np.ndarray,
                            elem_sort: tuple):
    """(u, ep) of a solve on a permuted mesh -> the reference mesh's order.

    u (n_n, 2) on `permute_mesh`'s node order: u_ref[old] = u[new_of_old[old]].
    ep (4, n_int) on elements sorted by `esort` (sorted[k] = original[esort[k]],
    `elem_sort` = (esort, n_q, n_real)), element-major points, padding
    points last and left in place."""
    esort, n_q, n_real = elem_sort
    body = ep[:, : n_real * n_q].reshape(ep.shape[0], n_real, n_q)
    restored = np.empty_like(body)
    restored[:, esort, :] = body
    ep = np.concatenate(
        [restored.reshape(ep.shape[0], n_real * n_q), ep[:, n_real * n_q:]], axis=-1
    )
    return u[new_of_old], ep


def host_element_stiffness(
    coords: np.ndarray, elems: np.ndarray, ref: ReferenceElement, d33: np.ndarray
) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy K_e = sum_q w_q B^T D B (setup-time, f64).

    d33: (3, 3) constant material tangent.  Returns (ke (n_e, 2n_p, 2n_p)
    f64, edofs (n_e, 2n_p)).
    """
    coords = np.asarray(coords, np.float64)
    elems = np.asarray(elems)
    xe = coords[elems]  # (n_e, n_p, 2)
    dN = np.asarray(ref.dN, np.float64)  # (n_q, n_p, 2)
    n_q, n_p, _ = dN.shape
    n_e = elems.shape[0]
    J = np.einsum("qpi,epj->eqij", dN, xe)
    det = J[..., 0, 0] * J[..., 1, 1] - J[..., 0, 1] * J[..., 1, 0]
    inv = np.empty_like(J)
    inv[..., 0, 0] = J[..., 1, 1]
    inv[..., 0, 1] = -J[..., 0, 1]
    inv[..., 1, 0] = -J[..., 1, 0]
    inv[..., 1, 1] = J[..., 0, 0]
    inv /= det[..., None, None]
    dphi = np.einsum("eqij,qpj->eqpi", inv, dN)  # (n_e, n_q, n_p, 2)
    w = np.abs(det) * np.asarray(ref.w, np.float64)[None, :]

    B = np.zeros((n_e, n_q, 3, 2 * n_p))
    B[:, :, 0, 0::2] = dphi[..., 0]
    B[:, :, 1, 1::2] = dphi[..., 1]
    B[:, :, 2, 0::2] = dphi[..., 1]
    B[:, :, 2, 1::2] = dphi[..., 0]
    DB = np.einsum("ab,eqbj->eqaj", np.asarray(d33, np.float64), B)
    ke = np.einsum("eqai,eqaj,eq->eij", B, DB, w)
    edofs = np.stack([2 * elems, 2 * elems + 1], axis=-1).reshape(n_e, -1)
    return ke, edofs


def assemble_csr(ke: np.ndarray, edofs: np.ndarray, n2: int):
    """Scatter element matrices into a scipy CSR (setup-time only)."""
    n_e, n2p, _ = ke.shape
    rows = np.repeat(edofs, n2p, axis=1).reshape(-1)
    cols = np.tile(edofs, (1, n2p)).reshape(-1)
    K = sp.coo_matrix((ke.reshape(-1), (rows, cols)), shape=(n2, n2)).tocsr()
    K.sum_duplicates()
    return K


def csr_lookup(K_csr, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Vectorized CSR entry lookup: index k with (row, col), else -1."""
    n2 = K_csr.shape[1]
    deg = np.diff(K_csr.indptr)
    all_keys = (
        np.repeat(np.arange(K_csr.shape[0], dtype=np.int64), deg) * n2
        + K_csr.indices.astype(np.int64)
    )
    q = rows.astype(np.int64) * n2 + cols.astype(np.int64)
    k = np.searchsorted(all_keys, q)
    k = np.minimum(k, max(all_keys.size - 1, 0))
    hit = all_keys[k] == q if all_keys.size else np.zeros(q.shape, bool)
    return np.where(hit, k, -1)


def apply_bc_csr(K, free_flat: np.ndarray):
    """Zero constrained rows/cols, unit diagonal.

    Scales `K.data` in place rather than multiplying by diagonal matrices:
    scipy's sparse matmul prunes zero-valued results, and the full
    element-connectivity pattern must survive.  Structured meshes carry
    exact zeros in the elastic stiffness at positions the plastic tangent
    needs: the static-structure value refresh scatters into them
    (`element_corr_dest`).
    """
    free = np.asarray(free_flat).reshape(-1)
    Kf = K.tocsr().copy()
    Kf.sum_duplicates()
    rows = np.repeat(np.arange(Kf.shape[0]), np.diff(Kf.indptr))
    Kf.data = Kf.data * (free[rows] & free[Kf.indices])
    # every diagonal is structurally present: each DOF belongs to an element
    con = np.nonzero(~free)[0]
    kd = csr_lookup(Kf, con, con)
    assert (kd >= 0).all(), "missing diagonal entries in the FEM pattern"
    Kf.data[kd] = 1.0
    return Kf


def diag_blocks_csr(K_csr, n_n: int) -> np.ndarray:
    """(n_n, 2, 2) nodal diagonal blocks from CSR (host, for smoothers)."""
    out = np.zeros((n_n, 2, 2))
    K = K_csr.tocsr()
    for di in range(2):
        for dj in range(2):
            out[:, di, dj] = K[di::2, dj::2].diagonal()
    return out


def build_elastic_csr(
    coords: np.ndarray, elems: np.ndarray, ref: ReferenceElement,
    shear: float, bulk: float, free: Optional[np.ndarray] = None,
):
    """Elastic stiffness as a scipy CSR (f64, sorted indices) in one call.

    `free`: (n_n, 2) bool mask; constrained rows/cols are zeroed with unit
    diagonal so the operator is SPD on the whole space.
    """
    dd = 4.0 * shear / 3.0 + bulk
    oo = -2.0 * shear / 3.0 + bulk
    d33 = np.array([[dd, oo, 0.0], [oo, dd, 0.0], [0.0, 0.0, shear]])
    ke, edofs = host_element_stiffness(coords, elems, ref, d33)
    K = assemble_csr(ke, edofs, 2 * coords.shape[0])
    if free is not None:
        K = apply_bc_csr(K, np.asarray(free).reshape(-1))
    return K


def element_corr_dest(K_csr, elems: np.ndarray, free_flat: np.ndarray) -> np.ndarray:
    """(n_e, 2n_p, 2n_p) int32 scatter destinations of per-element tangent
    correction blocks: the index into `K_csr.data` (and so into the device
    operator's `values`, `csr_to_device` keeps the order) of each entry.

    Entries whose row or column DOF is constrained get -1 and are dropped
    by the refresh: the assembled operator zeroes those rows/cols
    (`apply_bc_csr`) and CG masks them, so leaving the correction out there
    is exact.  Local DOF order is the interleaved [2v0, 2v0+1, 2v1, ...] of
    `Geometry.edofs` / `plastic_correction_gather`.
    """
    assert K_csr.has_sorted_indices, "element_corr_dest needs sorted CSR indices"
    elems = np.asarray(elems)
    edofs = np.stack([2 * elems, 2 * elems + 1], axis=-1).reshape(elems.shape[0], -1)
    n2p = edofs.shape[1]
    rows = np.repeat(edofs, n2p, axis=1).reshape(-1)
    cols = np.tile(edofs, (1, n2p)).reshape(-1)
    free = np.asarray(free_flat).reshape(-1)
    k = csr_lookup(K_csr, rows, cols)
    ok = (k >= 0) & free[rows] & free[cols]
    dest = np.where(ok, k, -1)
    assert dest.max(initial=-1) < np.iinfo(np.int32).max
    return dest.reshape(elems.shape[0], n2p, n2p).astype(np.int32)


def build_residual_csr(
    B64: np.ndarray, w64: np.ndarray, edofs: np.ndarray, n_q: int, n_nodes: int
):
    """Assembled strain and force operators of the Newton residual (host, f64).

      e_flat = G u      G: (3*n_int, 2*n_n), G[a*n_int+q, dof(e_q,p)] = B[a,p,q]
      F      = S s_flat S: (2*n_n, 3*n_int), S[dof, a*n_int+q] = w_q B[a,p,q]

    Rows and columns are component-major, matching the (3, n_int) lane
    layout reshaped flat.  Exact zeros of B are dropped, so the padding
    integration points (zero B, zero weight) have no entries.
    B64: (3, 2*n_p, n_int); w64: (n_int,); edofs: (n_e, 2*n_p) including
    padding elements.  Returns scipy CSR matrices (G, S).
    """
    B64 = np.asarray(B64, np.float64)
    w64 = np.asarray(w64, np.float64)
    edofs = np.asarray(edofs, np.int64)
    _, n_p2, n_int = B64.shape
    n2 = 2 * n_nodes
    qp = np.arange(n_int, dtype=np.int64)
    dof_pq = edofs[qp // n_q]  # (n_int, 2n_p)

    a_ix = np.repeat(np.arange(3, dtype=np.int64), n_p2 * n_int)
    p_ix = np.tile(np.repeat(np.arange(n_p2, dtype=np.int64), n_int), 3)
    q_ix = np.tile(qp, 3 * n_p2)
    vals = B64.reshape(-1)
    nz = vals != 0.0
    a_ix, p_ix, q_ix, vals = a_ix[nz], p_ix[nz], q_ix[nz], vals[nz]
    rows_e = a_ix * n_int + q_ix
    cols_u = dof_pq[q_ix, p_ix]

    G = sp.coo_matrix((vals, (rows_e, cols_u)), shape=(3 * n_int, n2)).tocsr()
    G.sum_duplicates()
    S = sp.coo_matrix(
        (vals * w64[q_ix], (cols_u, rows_e)), shape=(n2, 3 * n_int)
    ).tocsr()
    S.sum_duplicates()
    return G, S


def csr_matvec_plain(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A x: entry products, then a segmented row sum."""
    counts = A.indptr[1:] - A.indptr[:-1]
    rows = torch.repeat_interleave(
        torch.arange(A.n_rows, device=x.device), counts.long(),
        output_size=A.values.shape[0],
    )
    prod = A.values * x[A.indices.long()]
    y = torch.zeros(A.n_rows, dtype=prod.dtype, device=x.device)
    return y.index_add_(0, rows, prod)


def csr_matvec_row_serial(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A x for f32 values in the CSR kernel's order: the
    rows padded with zeros to the longest, then, column by column, one
    product and one add as separate ops, so each row is summed serially
    in CSR order with the product and the sum rounded apart.  A padded
    product is 0 and leaves the sum as it is: the CSR kernel's y bit for
    bit.  Reads the longest row's length from the card; not for a CUDA
    graph."""
    counts = (A.indptr[1:] - A.indptr[:-1]).long()
    width = int(counts.max()) if A.n_rows else 0
    slot = torch.arange(width, device=x.device)
    k = A.indptr[:-1, None].long() + slot
    present = slot < counts[:, None]
    k = torch.where(present, k, 0)
    v = torch.where(present, A.values[k], 0.0)
    xg = x[A.indices.long()[k]]
    y = torch.zeros(A.n_rows, dtype=x.dtype, device=x.device)
    for j in range(width):
        y = y + v[:, j] * xg[:, j]
    return y


@functools.lru_cache(maxsize=None)
def _library() -> ctypes.CDLL:
    from ..utils.cuda_build import build_library

    lib = build_library(KERNEL_SOURCE, "csr_spmv", ("-fmad=false",))
    for fn in (lib.csr_spmv_f64, lib.csr_spmv_f32):
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library_sweep() -> ctypes.CDLL:
    from ..utils.cuda_build import build_library

    lib = build_library(SWEEP_SOURCE, "block_jacobi_sweep", ("-fmad=false",))
    lib.block_jacobi_sweep.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]  # ..., update, node_offset, stream
    lib.block_jacobi_sweep_bf16.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 9 + [
        ctypes.c_int, ctypes.c_void_p]
    for fn in (lib.block_jacobi_sweep, lib.block_jacobi_sweep_bf16):
        fn.restype = ctypes.c_int
    lib.node_block_spmv.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
    lib.node_block_spmv.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library_transfer() -> ctypes.CDLL:
    from ..utils.cuda_build import build_library

    lib = build_library(TRANSFER_SOURCE, "node_transfer", ("-fmad=false",))
    lib.node_transfer.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 7 + [ctypes.c_int,
                                                                         ctypes.c_void_p]
    lib.node_transfer.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def _library_ell() -> ctypes.CDLL:
    from ..utils.cuda_build import build_library

    lib = build_library(ELL_SOURCE, "ell_spmv", ("-fmad=false",))
    for fn in (lib.ell_spmv_f32, lib.ell_spmv_f64):
        fn.argtypes = [ctypes.c_int] * 3 + [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int
    return lib


def load_kernel() -> None:
    """Build (first use) and load K1 and K3's CSR kernel (one source);
    raises if the build fails."""
    _library()


def load_sweep_kernel() -> None:
    """Build (first use) and load K4, K5 and K3's node-block product; raises
    if the build fails."""
    _library_sweep()


def load_transfer_kernel() -> None:
    """Build (first use) and load K3's transfer kernel; raises if the build
    fails."""
    _library_transfer()


def load_ell_kernel() -> None:
    """Build (first use) and load K6; raises if the build fails."""
    _library_ell()


def _check_csr(name: str, A: CsrMatrix, x: torch.Tensor, dtype: torch.dtype, extra=(),
               values_dtype: Optional[torch.dtype] = None):
    """Raise unless A, x and the `extra` (name, tensor, shape) vectors are
    contiguous tensors of `dtype` (int32 for the structure, `values_dtype`
    for A's values if given) on x's CUDA device with consistent shapes."""
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor; got one on {x.device}")
    named = [
        ("indptr", A.indptr, torch.int32, (A.n_rows + 1,)),
        ("indices", A.indices, torch.int32, tuple(A.values.shape)),
        ("values", A.values, values_dtype or dtype, tuple(A.indices.shape)),
        ("x", x, dtype, (A.shape[1],)),
    ] + [(n, t, dtype, shape) for n, t, shape in extra]
    for nm, t, dt, shape in named:
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(
                f"{name}: {nm} must be a contiguous {dt} tensor on {x.device}; "
                f"got {t.dtype} on {t.device}"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {nm} has shape {tuple(t.shape)}, expected {shape}")


def _csr_spmv_cuda(name: str, dtype, A: CsrMatrix, x: torch.Tensor):
    _check_csr(name, A, x, dtype)
    rb = A.row_blocks
    if rb is None:
        raise ValueError(f"{name}: the matrix has no row blocks; make it with csr_to_device")
    if (rb.device != x.device or rb.dtype != torch.int32 or not rb.is_contiguous()
            or rb.dim() != 2 or rb.shape[0] < 1 or rb.shape[1] != 2):
        raise ValueError(f"{name}: row_blocks must be a contiguous (n_blocks + 1, 2) int32 "
                         f"tensor on {x.device}; got {rb.dtype} {tuple(rb.shape)} on {rb.device}")
    y = torch.empty(A.n_rows, dtype=dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(_library(), name)(
        rb.shape[0] - 1, rb.data_ptr(), A.indptr.data_ptr(), A.indices.data_ptr(),
        A.values.data_ptr(), x.data_ptr(), y.data_ptr(), ROW_BLOCK_ENTRIES, ROW_BLOCK_ROWS,
        int(csr_streams(A)), stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    return y


def csr_spmv_f64_cuda(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch K1 on x's device and PyTorch's current stream; no sync."""
    if not x.is_cuda:
        raise ValueError(f"csr_spmv_f64 needs a CUDA tensor; got one on {x.device}")
    return _csr_spmv_cuda("csr_spmv_f64", torch.float64, A, x)


def csr_spmv_f32_cuda(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch K3's f32 CSR kernel on x's device and
    PyTorch's current stream; no sync.  A may be rectangular."""
    if not x.is_cuda:
        raise ValueError(f"csr_spmv_f32 needs a CUDA tensor; got one on {x.device}")
    return _csr_spmv_cuda("csr_spmv_f32", torch.float32, A, x)


def csr_matvec(A: CsrMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x.  On a CUDA tensor: K1 for f64 values, the f32 CSR kernel
    for f32 values; on a CPU tensor the plain version."""
    if A.values.dtype not in (torch.float64, torch.float32):
        raise ValueError(f"csr_matvec: no kernel for {A.values.dtype} values")
    f64 = A.values.dtype == torch.float64
    if x.is_cuda:
        return csr_spmv_f64_cuda(A, x) if f64 else csr_spmv_f32_cuda(A, x)
    if x.device.type != "cpu":
        raise ValueError(f"csr_matvec: no route for device {x.device}")
    LAUNCHES["csr_spmv_f64_plain" if f64 else "csr_spmv_f32_plain"] += 1
    return csr_matvec_plain(A, x)


# ---------------------------------------------------------------------------
# K4 and K5: the fused damped block-Jacobi sweep on 2x2 node blocks
# ---------------------------------------------------------------------------
class SweepAux(NamedTuple):
    """Per-level constants of the fused sweep, flat (2*n_n,) f32 vectors:
    for DOF i = 2k+c, mask[i] = 1 where free else 0, msf[i] = inv[k, c, c]
    (own-component coefficient), mpr[i] = inv[k, c, 1-c] (partner)."""

    mask: torch.Tensor
    msf: torch.Tensor
    mpr: torch.Tensor


def sweep_aux(inv: np.ndarray, free_flat: np.ndarray, device) -> SweepAux:
    """Host build of the sweep constants (`build_sweep_aux`, without the
    TPU kernel's tile padding).  inv: (n_n, 2, 2) damped block-Jacobi
    inverse (omega included); free_flat: (2*n_n,) bool."""
    free_flat = np.asarray(free_flat).reshape(-1)
    n = free_flat.shape[0]
    inv = np.asarray(inv, np.float32)
    k = np.arange(n) // 2
    cc = np.arange(n) % 2
    as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)  # noqa: E731
    return SweepAux(
        mask=as_t(free_flat.astype(np.float32)),
        msf=as_t(inv[k, cc, cc]),
        mpr=as_t(inv[k, cc, 1 - cc]),
    )


# the sweep's kernel, by the block values' type
SWEEP_KERNELS = {torch.float32: "block_jacobi_sweep", torch.bfloat16: "block_jacobi_sweep_bf16"}


class NodeBlockMatrix(NamedTuple):
    """A square operator with 2x2 nodal blocks: the sweep's layout (K4, K5)
    and, with f32 values, the fine level's product's (K3).

    Node k (rows 2k and 2k+1) owns blocks node_ptr[k] .. node_ptr[k+1]-1,
    in ascending neighbour node m = block_cols[b]; block_values[b] holds
    a(2k,2m), a(2k,2m+1), a(2k+1,2m), a(2k+1,2m+1), f32 (K4) or bf16 (K5).
    `width` is the most blocks a node has (kept so that the plain version
    needs no host read).  A row slice (`shard_rows`) holds nodes
    node_offset .. node_offset + n_nodes - 1 of an operator over
    `col_nodes` nodes; its columns stay global."""

    node_ptr: torch.Tensor  # (n_nodes + 1,) int32
    block_cols: torch.Tensor  # (n_blocks,) int32
    block_values: torch.Tensor  # (n_blocks, 4) float32 or bfloat16
    width: int
    node_offset: int = 0  # the slice's first node in the whole operator
    col_nodes: int = 0  # nodes of the whole operator (0: n_nodes, square)

    @property
    def n_nodes(self) -> int:
        return self.node_ptr.shape[0] - 1

    @property
    def shape(self) -> Tuple[int, int]:
        return (2 * self.n_nodes, 2 * (self.col_nodes or self.n_nodes))

    @property
    def is_slice(self) -> bool:
        return self.node_offset != 0 or self.shape[0] != self.shape[1]

    def blocks_per_node(self) -> torch.Tensor:
        return self.node_ptr[1:] - self.node_ptr[:-1]


def _node_block_layout(A: CsrMatrix):
    """(node_ptr, block_cols, the block-value position of each entry of A,
    blocks a node) of A's 2x2 node blocks, on A's device; raises as
    `node_blocks` does."""
    n = A.shape[0]
    if A.shape[0] != A.shape[1] or n % 2:
        raise ValueError(f"node_blocks: operator {A.shape} is not square with an even size")
    dev = A.indices.device
    cols = A.indices.long()
    nnz = cols.shape[0]
    rows = torch.repeat_interleave(
        torch.arange(n, device=dev), (A.indptr[1:] - A.indptr[:-1]).long(), output_size=nnz)
    same_row = rows[1:] == rows[:-1]
    if bool((same_row & (cols[1:] <= cols[:-1])).any()):
        raise ValueError("node_blocks: column indices do not ascend strictly within a row")
    m = cols // 2
    # the first entry of each (row, node column) pair
    first = torch.ones(nnz, dtype=torch.bool, device=dev)
    first[1:] = ~same_row | (m[1:] != m[:-1])
    u_rows, u_m = rows[first], m[first]
    per_row = torch.bincount(u_rows, minlength=n)
    even = u_rows % 2 == 0
    if not (torch.equal(per_row[0::2], per_row[1::2]) and torch.equal(u_m[even], u_m[~even])):
        raise ValueError("node_blocks: rows 2k and 2k+1 differ in their node columns; "
                         "the operator is not 2x2-blocked")
    per_node = per_row[0::2]
    node_ptr = torch.zeros(n // 2 + 1, dtype=torch.long, device=dev)
    node_ptr[1:] = torch.cumsum(per_node, 0)
    block_cols = u_m[even]
    assert block_cols.shape[0] < np.iinfo(np.int32).max // 4, \
        "node blocks too many for int32 offsets"
    # pair j of row 2k and pair j of row 2k+1 are block node_ptr[k] + j
    rank = torch.where(even, torch.cumsum(even.long(), 0), torch.cumsum((~even).long(), 0)) - 1
    blk = rank[torch.cumsum(first.long(), 0) - 1]
    return node_ptr, block_cols, 4 * blk + 2 * (rows % 2) + cols % 2, per_node


def node_block_positions(A: CsrMatrix) -> torch.Tensor:
    """(nnz,) int64 on A's device: where `node_blocks(A)` puts CSR entry k
    in `block_values.reshape(-1)`, 4 blk + 2 (row % 2) + col % 2.  A
    bijection onto the present entries; raises as `node_blocks` does."""
    return _node_block_layout(A)[2]


def node_block_dest(dest: np.ndarray, K_csr, device) -> torch.Tensor:
    """`element_corr_dest`'s table for `K_csr` (positions in its CSR values,
    -1 for dropped entries) mapped to the positions of the same entries in
    the values of `node_blocks` of that CSR (-1 kept): an int32 tensor on
    `device`, where the map is computed.

    The map is a bijection, so a refresh through the mapped table adds the
    same contributions to each entry in the same order: its block values
    are `node_blocks` of the refreshed CSR bit for bit."""
    pos = node_block_positions(csr_to_device(K_csr, device, np.float32))
    d = torch.as_tensor(np.asarray(dest), device=device).long()
    return torch.where(d >= 0, pos[d.clamp(min=0)], -1).to(torch.int32)


def node_blocks(A: CsrMatrix, dtype: torch.dtype = torch.float32) -> NodeBlockMatrix:
    """The 2x2 node-block layout of a level's f32 operator, on A's device,
    with f32 values (K4, K3's product) or bf16 ones rounded to nearest even
    (K5, the rounding of the JAX package's `pack_slot_bf16`).

    Raises ValueError unless A is square with an even size, its column
    indices ascend strictly within each row, and rows 2k and 2k+1 have the
    same node columns m (every entry in a 2x2 block whose rows share their
    node columns).  An entry missing from a block that is present is stored
    as an explicit zero."""
    if A.values.dtype != torch.float32:
        raise ValueError(f"node_blocks needs f32 values; got {A.values.dtype}")
    if dtype not in SWEEP_KERNELS:
        raise ValueError(f"node_blocks: no sweep kernel for {dtype} values")
    node_ptr, block_cols, pos, per_node = _node_block_layout(A)
    n_blocks = block_cols.shape[0]
    values = torch.zeros(n_blocks * 4, dtype=torch.float32, device=A.values.device)
    values[pos] = A.values
    return NodeBlockMatrix(
        node_ptr=node_ptr.to(torch.int32),
        block_cols=block_cols.to(torch.int32),
        block_values=values.reshape(n_blocks, 4).to(dtype),
        width=int(per_node.max()) if per_node.numel() else 0,
    )


def _padded(node_ptr: torch.Tensor, width: int, n_entries: int):
    """Slot-major padding of a node layout: (width * n_nodes,) entry index
    of node k's slot j at j * n_nodes + k, `n_entries` (an appended padding
    entry) past the node's own, and the (width, n_nodes) mask of the
    node's own slots.  No host read (the card's timings capture the plain
    versions in a CUDA graph)."""
    j = torch.arange(width, device=node_ptr.device)[:, None]
    own = j < (node_ptr[1:] - node_ptr[:-1])
    return torch.where(own, node_ptr[:-1] + j, n_entries).reshape(-1), own


def _node_block_accumulate(B: NodeBlockMatrix, z: torch.Tensor) -> torch.Tensor:
    """B z in the kernel's order, (2 n_nodes,) f32: the layout padded to
    `B.width` blocks a node (padding blocks: value 0, column 0); over the
    blocks j in order, each row adds a(., 2m) z_2m, then a(., 2m+1)
    z_2m+1, each product and each sum rounded on its own (`torch.mul`,
    `torch.add`: nothing fuses them into an FMA).  bf16 values are widened
    to f32 (exactly) and the arithmetic is f32."""
    n_nodes, width = B.n_nodes, B.width
    idx, _ = _padded(B.node_ptr.long(), width, B.block_cols.shape[0])
    vals = torch.cat([B.block_values.to(torch.float32),
                      B.block_values.new_zeros(1, 4, dtype=torch.float32)]).index_select(0, idx)
    cols = torch.cat([B.block_cols, B.block_cols.new_zeros(1)]).index_select(0, idx).long()
    # z_2m, z_2m+1, z_2m, z_2m+1 against a(2k,2m), a(2k,2m+1), a(2k+1,2m), a(2k+1,2m+1)
    lanes = torch.arange(4, device=z.device) % 2  # no host copy: CUDA graph capture
    zg = z.index_select(0, (2 * cols[:, None] + lanes).reshape(-1)).view(-1, 4)
    # [j, node, row, d] -> [j, d, node, row]: each add reads a contiguous (n_nodes, 2)
    prods = torch.mul(vals, zg).view(width, n_nodes, 2, 2).permute(0, 3, 1, 2).contiguous()
    acc = torch.zeros(n_nodes, 2, dtype=torch.float32, device=z.device)
    for j in range(width):
        for d in range(2):
            acc = torch.add(acc, prods[j, d])
    return acc.reshape(-1)


def node_block_sweep_plain(
    B: NodeBlockMatrix, aux: SweepAux, z: torch.Tensor, r: torch.Tensor, update: bool = True
) -> torch.Tensor:
    """Plain PyTorch sweep on the node-block layout: the kernel's order and
    rounding (`_node_block_accumulate`), so the two agree bit for bit.  On
    a row slice z is the whole operator's, r and aux the slice's rows, and
    the update adds to z's rows of the slice (`B.node_offset`)."""
    return _sweep_epilogue(aux, _own_rows(z, B.node_offset, B.n_nodes), r,
                           _node_block_accumulate(B, z), update)


def _own_rows(z: torch.Tensor, node_offset: int, n_nodes: int) -> torch.Tensor:
    """The rows of nodes node_offset .. node_offset + n_nodes - 1 of z."""
    return z[2 * node_offset:2 * (node_offset + n_nodes)]


def node_block_matvec_plain(B: NodeBlockMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = B x: the sweep's accumulation without its
    epilogue, in the kernel's order, so the two agree bit for bit."""
    return _node_block_accumulate(B, x)


def _sweep_epilogue(aux: SweepAux, z, r, Az, update: bool):
    res = (r - Az) * aux.mask
    if not update:
        return res
    res_sw = res.reshape(-1, 2).flip(1).reshape(-1)
    return z + (aux.msf * res + aux.mpr * res_sw) * aux.mask


def block_jacobi_sweep_plain(
    A: CsrMatrix, aux: SweepAux, z: torch.Tensor, r: torch.Tensor, update: bool = True,
    node_offset: int = 0,
) -> torch.Tensor:
    """Plain PyTorch sweep on the CSR operator the node blocks were made
    from: res = mask (r - A z); with `update` z + mask (msf res + mpr
    res_partner), else res.  The second reference of K4 and K5: its row sum
    (`index_add_`) may take another order than the kernel's.  bf16 values
    are widened to f32 (exactly) and the arithmetic is f32.  A may be the
    row slice of nodes node_offset .. of an operator whose vector z is: the
    update adds to z's rows of the slice."""
    if A.values.dtype == torch.bfloat16:
        A = A._replace(values=A.values.to(torch.float32))
    return _sweep_epilogue(aux, _own_rows(z, node_offset, A.n_rows // 2), r,
                           csr_matvec_plain(A, z), update)


def _sweep_kernel(B) -> str:
    """The sweep kernel's name for B's block values; raises unless B is a
    `NodeBlockMatrix` with f32 or bf16 values (no route for a CSR)."""
    if not isinstance(B, NodeBlockMatrix):
        raise ValueError(f"block_jacobi_sweep needs a NodeBlockMatrix; got {type(B).__name__}")
    name = SWEEP_KERNELS.get(B.block_values.dtype)
    if name is None:
        raise ValueError(f"block_jacobi_sweep: no kernel for {B.block_values.dtype} values")
    return name


def _sweep_name(B) -> str:
    """The sweep launch's name: `_sweep_kernel`'s, or on a row slice of f32
    blocks the split-z instance's, "block_jacobi_sweep_split"; raises on a
    bf16 slice or a slice outside its operator."""
    name = _sweep_kernel(B)
    if not B.is_slice:
        return name
    if name != "block_jacobi_sweep":
        raise ValueError(f"{name}: no split-z instance (row slices smooth f32 blocks)")
    if B.node_offset < 0 or B.node_offset + B.n_nodes > B.shape[1] // 2:
        raise ValueError(f"block_jacobi_sweep_split: nodes {B.node_offset} .. "
                         f"{B.node_offset + B.n_nodes} outside the operator's {B.shape[1] // 2}")
    return "block_jacobi_sweep_split"


def _check_args(name: str, device: torch.device, named) -> None:
    """Raise unless each (name, tensor, dtype, shape) of `named` is a
    contiguous tensor of that dtype and shape on `device`."""
    for nm, t, dt, shape in named:
        if t.device != device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be a contiguous {dt} tensor on {device}; "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {nm} has shape {tuple(t.shape)}, expected {shape}")


def _node_block_args(B: NodeBlockMatrix):
    n_blocks = B.block_cols.shape[0]
    return [("node_ptr", B.node_ptr, torch.int32, (B.n_nodes + 1,)),
            ("block_cols", B.block_cols, torch.int32, (n_blocks,)),
            ("block_values", B.block_values, B.block_values.dtype, (n_blocks, 4))]


def _aliases(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def block_jacobi_sweep_cuda(
    B: NodeBlockMatrix, aux: SweepAux, z: torch.Tensor, r: torch.Tensor,
    update: bool = True, out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Launch K4 (f32 blocks) or K5 (bf16 blocks) on z's device and
    PyTorch's current stream; no sync.

    The sweep is Jacobi: every row reads the old z, so `out` (allocated
    here unless given) must not share memory with z.

    On a row slice of f32 blocks (`NodeBlockMatrix.is_slice`) this is the
    split-z instance, counted as "block_jacobi_sweep_split": z is the whole
    operator's vector, which the product reads at global columns; r, aux
    and out are the slice's rows, and the update reads z at the slice's
    own rows (`node_offset`).  The bf16 instance has no split form (the
    JAX package refuses a packed hierarchy under sharding).
    """
    if not z.is_cuda:
        raise ValueError(f"block_jacobi_sweep needs a CUDA tensor; got one on {z.device}")
    name = _sweep_name(B)
    n2 = 2 * B.n_nodes
    if out is None:
        out = torch.empty(n2, dtype=torch.float32, device=z.device)
    _check_args(name, z.device, _node_block_args(B) + [("z", z, torch.float32, (B.shape[1],))] + [
        (nm, t, torch.float32, (n2,)) for nm, t in (
            ("r", r), ("mask", aux.mask), ("msf", aux.msf), ("mpr", aux.mpr),
            ("out", out))])
    if _aliases(out, z):
        raise ValueError(f"{name}: out must not alias z")
    # float2 loads of the vectors and of z's gathered pairs; one 16-byte
    # (f32) or 8-byte (bf16) load a block
    if any(t.data_ptr() % 8 for t in (z, r, out, *aux)) or (
            B.block_values.data_ptr() % (4 * B.block_values.element_size())):
        raise ValueError(f"{name}: vectors must be 8-byte aligned, block values "
                         f"{4 * B.block_values.element_size()}-byte aligned")
    stream = torch.cuda.current_stream(z.device).cuda_stream
    # the f32 entry takes the slice's node offset; the bf16 one has none
    f32 = name != "block_jacobi_sweep_bf16"
    err = getattr(_library_sweep(), "block_jacobi_sweep" if f32 else name)(
        B.n_nodes, B.node_ptr.data_ptr(), B.block_cols.data_ptr(),
        B.block_values.data_ptr(), z.data_ptr(), r.data_ptr(), aux.mask.data_ptr(),
        aux.msf.data_ptr(), aux.mpr.data_ptr(), out.data_ptr(), int(bool(update)),
        *((B.node_offset,) if f32 else ()), stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def block_jacobi_sweep(
    B: NodeBlockMatrix, aux: SweepAux, z: torch.Tensor, r: torch.Tensor, update: bool = True
) -> torch.Tensor:
    """One fused smoother sweep, or the masked residual, on a node-block
    operator with f32 values (K4) or bf16 values (K5): the kernel on a CUDA
    tensor, the plain version on a CPU tensor.  On a `RowShard` of node
    blocks: the split-z sweep of the rank's rows (r and aux cut to them, z
    whole), then the gather of every rank's."""
    if isinstance(B, RowShard):
        if not B.rows:
            return B.gather(z.new_zeros(0))
        return B.gather(block_jacobi_sweep(B.local, SweepAux(*(a[B.own] for a in aux)), z,
                                           r[B.own], update))
    if z.is_cuda:
        return block_jacobi_sweep_cuda(B, aux, z, r, update)
    if z.device.type != "cpu":
        raise ValueError(f"block_jacobi_sweep: no route for device {z.device}")
    LAUNCHES[_sweep_name(B) + "_plain"] += 1
    return node_block_sweep_plain(B, aux, z, r, update)


def packed_matvec(B: NodeBlockMatrix, v: torch.Tensor) -> torch.Tensor:
    """y = B v on bf16 node blocks (`slot_matvec_pk`, which only the JAX
    package's tests call), through K5's masked residual: with r = 0 and
    mask = 1 that residual is -(B v) exactly, so y is its negation."""
    zeros = torch.zeros_like(v)
    aux = SweepAux(mask=torch.ones_like(v), msf=zeros, mpr=zeros)
    return -block_jacobi_sweep(B, aux, v, zeros, update=False)


# ---------------------------------------------------------------------------
# K3: the product on f32 node blocks, and the transfers node by node
# ---------------------------------------------------------------------------
def _check_f32_blocks(name: str, B) -> None:
    if not isinstance(B, NodeBlockMatrix):
        raise ValueError(f"{name} needs a NodeBlockMatrix; got {type(B).__name__}")
    if B.block_values.dtype != torch.float32:
        raise ValueError(f"{name}: no kernel for {B.block_values.dtype} values")


def node_block_spmv_cuda(B: NodeBlockMatrix, x: torch.Tensor,
                         out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3's product y = B x on f32 node blocks (the sweep kernel's
    product epilogue) on x's device and PyTorch's current stream; no sync.
    `out` (allocated here unless given) must not share memory with x."""
    name = "node_block_spmv"
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor; got one on {x.device}")
    _check_f32_blocks(name, B)
    n2 = 2 * B.n_nodes
    if out is None:
        out = torch.empty(n2, dtype=torch.float32, device=x.device)
    _check_args(name, x.device, _node_block_args(B) + [
        ("x", x, torch.float32, (B.shape[1],)), ("out", out, torch.float32, (n2,))])
    if _aliases(out, x):
        raise ValueError(f"{name}: out must not alias x")
    if x.data_ptr() % 8 or out.data_ptr() % 8 or B.block_values.data_ptr() % 16:
        raise ValueError(f"{name}: vectors must be 8-byte aligned, block values 16-byte aligned")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library_sweep().node_block_spmv(
        B.n_nodes, B.node_ptr.data_ptr(), B.block_cols.data_ptr(), B.block_values.data_ptr(),
        x.data_ptr(), out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def node_block_matvec(B: NodeBlockMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = B x on f32 node blocks: K3's product on a CUDA tensor, the plain
    version on a CPU tensor.  It equals the CSR row sums in index order
    (the earlier K3, `csr_spmv_f32`) bit for bit."""
    if x.is_cuda:
        return node_block_spmv_cuda(B, x)
    if x.device.type != "cpu":
        raise ValueError(f"node_block_matvec: no route for device {x.device}")
    _check_f32_blocks("node_block_matvec", B)
    LAUNCHES["node_block_spmv_plain"] += 1
    return node_block_matvec_plain(B, x)


class NodeTransfer(NamedTuple):
    """A multigrid transfer that acts on both displacement components
    alike: P (fine node i copies or averages coarse nodes) or R = P^T, in
    node form (K3's transfers).

    Node k (rows 2k and 2k+1) owns entries node_ptr[k] .. node_ptr[k+1]-1:
    node column m = node_cols[e], ascending, and weight w = weights[e],
    standing for the DOF entries (2k, 2m, w) and (2k+1, 2m+1, w).  `width`
    is the most entries a node has (kept so that the plain version needs no
    host read)."""

    node_ptr: torch.Tensor  # (n_nodes + 1,) int32
    node_cols: torch.Tensor  # (n_entries,) int32
    weights: torch.Tensor  # (n_entries,) float32
    shape: Tuple[int, int]  # the DOF operator's (rows, columns)
    width: int

    @property
    def n_nodes(self) -> int:
        return self.node_ptr.shape[0] - 1


def node_transfer(T, device) -> NodeTransfer:
    """Host scipy CSR of a transfer (P or R) -> `NodeTransfer` on `device`,
    weights rounded to f32.

    Raises ValueError unless both sizes are even and rows 2k and 2k+1 carry
    the same node columns, row 2k's in even columns and row 2k+1's in odd
    ones, with equal weights: an operator that is not a node-level one
    times I_2."""
    T = sp.csr_matrix(T, copy=True)
    T.sort_indices()
    n_rows, n_cols = T.shape
    if n_rows % 2 or n_cols % 2:
        raise ValueError(f"node_transfer: operator {T.shape} has an odd size")
    assert max(T.nnz, n_cols) < np.iinfo(np.int32).max, "transfer too large for int32 indices"
    deg = np.diff(T.indptr)
    rows = np.repeat(np.arange(n_rows), deg)
    ev = rows % 2 == 0
    ce, co = T.indices[ev], T.indices[~ev]
    if not (np.array_equal(deg[0::2], deg[1::2]) and np.array_equal(ce // 2, co // 2)
            and (ce % 2 == 0).all() and (co % 2 == 1).all()
            and np.array_equal(T.data[ev], T.data[~ev])):
        raise ValueError("node_transfer: rows 2k and 2k+1 differ in their node columns or "
                         "weights; the operator is not a node-level one times I_2")
    per_node = deg[0::2]

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=device)

    return NodeTransfer(
        node_ptr=dev(np.concatenate([[0], np.cumsum(per_node)]), np.int32),
        node_cols=dev(ce // 2, np.int32), weights=dev(T.data[ev], np.float32),
        shape=(int(n_rows), int(n_cols)), width=int(per_node.max(initial=0)),
    )


def _transfer_epilogue(y: torch.Tensor, mask: Optional[torch.Tensor],
                       z: Optional[torch.Tensor]) -> torch.Tensor:
    if mask is None:
        return y
    y = torch.where(mask, y, torch.zeros((), dtype=y.dtype, device=y.device))
    return y if z is None else z + y


def node_transfer_plain(T: NodeTransfer, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                        z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch transfer in the kernel's order: each node's entries in
    order, w x_2m and w x_2m+1 as separate `torch.mul` and `torch.add`
    calls from +0 (entries past a node's own are skipped, not added as
    zeros); then `torch.where(mask, y, 0)` and `z + ...` as the V-cycle
    writes them (`transfer`'s modes)."""
    idx, own = _padded(T.node_ptr.long(), T.width, T.node_cols.shape[0])
    w = torch.cat([T.weights, T.weights.new_zeros(1)]).index_select(0, idx)
    cols = torch.cat([T.node_cols, T.node_cols.new_zeros(1)]).index_select(0, idx).long()
    # [j, node, component]
    prods = torch.mul(w[:, None], x.reshape(-1, 2).index_select(0, cols)).view(
        T.width, T.n_nodes, 2)
    acc = torch.zeros(T.n_nodes, 2, dtype=torch.float32, device=x.device)
    for j in range(T.width):
        acc = torch.where(own[j, :, None], torch.add(acc, prods[j]), acc)
    return _transfer_epilogue(acc.reshape(-1), mask, z)


_TRANSFER_MODES = {(False, False): 0, (True, False): 1, (True, True): 2}


def node_transfer_cuda(T: NodeTransfer, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       z: Optional[torch.Tensor] = None,
                       out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3's transfer on x's device and PyTorch's current stream; no
    sync.  `out` (allocated here unless given) must not share memory with
    x or z."""
    name = "node_transfer"
    if not x.is_cuda:
        raise ValueError(f"{name} needs a CUDA tensor; got one on {x.device}")
    if not isinstance(T, NodeTransfer):
        raise ValueError(f"{name} needs a NodeTransfer; got {type(T).__name__}")
    mode = _TRANSFER_MODES.get((mask is not None, z is not None))
    if mode is None:
        raise ValueError(f"{name}: z is added only under a mask")
    n_out = T.shape[0]
    if out is None:
        out = torch.empty(n_out, dtype=torch.float32, device=x.device)
    named = [("node_ptr", T.node_ptr, torch.int32, (T.n_nodes + 1,)),
             ("node_cols", T.node_cols, torch.int32, tuple(T.weights.shape)),
             ("weights", T.weights, torch.float32, tuple(T.node_cols.shape)),
             ("x", x, torch.float32, (T.shape[1],)), ("out", out, torch.float32, (n_out,))]
    if mask is not None:
        named.append(("mask", mask, torch.bool, (n_out,)))
    if z is not None:
        named.append(("z", z, torch.float32, (n_out,)))
    _check_args(name, x.device, named)
    if _aliases(out, x) or (z is not None and _aliases(out, z)):
        raise ValueError(f"{name}: out must not alias x or z")
    if any(t.data_ptr() % 8 for t in (x, out) + ((z,) if z is not None else ())):
        raise ValueError(f"{name}: x, z and out must be 8-byte aligned")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = _library_transfer().node_transfer(
        T.n_nodes, T.node_ptr.data_ptr(), T.node_cols.data_ptr(), T.weights.data_ptr(),
        x.data_ptr(), 0 if mask is None else mask.data_ptr(), 0 if z is None else z.data_ptr(),
        out.data_ptr(), mode, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    return out


def transfer(T: NodeTransfer, x: torch.Tensor, mask: Optional[torch.Tensor] = None,
             z: Optional[torch.Tensor] = None) -> torch.Tensor:
    """A multigrid transfer with the V-cycle's epilogue: y = T x; with
    `mask` (bool, the output level's free DOFs) where(mask, T x, 0), the
    restriction's right-hand side; with `mask` and `z` z + where(mask, T x,
    0), the prolongated correction.  K3's transfer kernel on a CUDA tensor,
    the plain version on a CPU tensor.  On a `RowShard` of a transfer: the
    rank's output rows (mask and z cut to them), then the gather."""
    if isinstance(T, RowShard):
        if not T.rows:
            return T.gather(x.new_zeros(0))
        return T.gather(transfer(T.local, x, None if mask is None else mask[T.own],
                                 None if z is None else z[T.own]))
    if x.is_cuda:
        return node_transfer_cuda(T, x, mask, z)
    if x.device.type != "cpu":
        raise ValueError(f"transfer: no route for device {x.device}")
    if z is not None and mask is None:
        raise ValueError("transfer: z is added only under a mask")
    LAUNCHES["node_transfer_plain"] += 1
    return node_transfer_plain(T, x, mask, z)


# ---------------------------------------------------------------------------
# K6: the sliced ELL format
# ---------------------------------------------------------------------------
ELL_SLICE = 32  # rows a slice: one warp, a thread a row


class EllMatrix(NamedTuple):
    """Sliced ELL operator on one device, f32 or f64 values (K6).

    Rows are grouped into slices of ELL_SLICE.  Slice s stores its rows'
    first `width_s` entries column-major from `slice_ptr[s]`: slot j of the
    row with lane l (row = ELL_SLICE s + l) sits at slice_ptr[s] +
    ELL_SLICE j + l, so the threads of a warp read neighbouring addresses.
    width_s is the longest of the slice's rows, at most `cap` (the JAX
    package's row-degree cap); padding slots hold value 0 and column 0.  A
    row's entries past the cap form its tail: a CSR over all rows
    (`tail_ptr`), which the same thread walks after its slots."""

    values: torch.Tensor  # (n_slots,) float32 or float64
    cols: torch.Tensor  # (n_slots,) int32
    slice_ptr: torch.Tensor  # (n_slices + 1,) int32, in slots
    tail_ptr: torch.Tensor  # (n_rows + 1,) int32
    tail_cols: torch.Tensor  # (n_tail,) int32
    tail_values: torch.Tensor  # (n_tail,) float32 or float64
    shape: Tuple[int, int]
    cap: int
    width: int  # every slice's width where they share one, else 0

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def n_slices(self) -> int:
        return self.slice_ptr.shape[0] - 1

    def widths(self) -> torch.Tensor:
        """(n_slices,) slots a row of each slice."""
        return (self.slice_ptr[1:] - self.slice_ptr[:-1]) // ELL_SLICE


def ell_degree_cap(deg_arr: np.ndarray, nnz: int, max_overflow_frac: float) -> int:
    """The JAX package's row-degree cap (`build_ell`, `spmv.py:198-214`): the
    least of the 90/99/99.9% row-degree quantiles and the full degree that
    spills at most half of `max_overflow_frac` of the entries."""
    deg_full = int(max(deg_arr.max(initial=0), 1))
    cands = sorted({int(np.quantile(deg_arr, q)) for q in (0.9, 0.99, 0.999)} | {deg_full})
    for cand in cands:
        cand = max(cand, 1)
        if int(np.maximum(deg_arr - cand, 0).sum()) <= 0.5 * max_overflow_frac * max(nnz, 1):
            return cand
    return deg_full


def build_ell(K_csr, device, dtype=np.float32, max_overflow_frac: float = 0.005) -> EllMatrix:
    """Host scipy CSR -> sliced `EllMatrix` on `device`, values rounded to
    `dtype`.  A row keeps its first `ell_degree_cap` entries in column order
    in its slice; the rest form its tail.  Works for rectangular operators
    (the multigrid transfers, S)."""
    K = sp.csr_matrix(K_csr, copy=True)
    K.sort_indices()
    n_rows, n_cols = K.shape
    assert n_cols < np.iinfo(np.int32).max and K.nnz < np.iinfo(np.int32).max
    deg_arr = np.diff(K.indptr)
    cap = ell_degree_cap(deg_arr, K.nnz, max_overflow_frac) if n_rows else 1
    n_slices = -(-n_rows // ELL_SLICE)
    deg_pad = np.zeros(n_slices * ELL_SLICE, np.int64)
    deg_pad[:n_rows] = deg_arr
    width = np.minimum(deg_pad.reshape(n_slices, ELL_SLICE).max(axis=1), cap)
    slice_ptr = np.concatenate([[0], np.cumsum(width * ELL_SLICE)])
    assert slice_ptr[-1] < np.iinfo(np.int32).max, "sliced ELL too large for int32 offsets"
    rowid = np.repeat(np.arange(n_rows), deg_arr)
    slot = np.arange(K.nnz) - K.indptr[rowid]
    keep = slot < cap
    pos = slice_ptr[rowid[keep] // ELL_SLICE] + slot[keep] * ELL_SLICE + rowid[keep] % ELL_SLICE
    vals = np.zeros(slice_ptr[-1], dtype)
    cols = np.zeros(slice_ptr[-1], np.int32)
    vals[pos] = K.data[keep]
    cols[pos] = K.indices[keep]
    tail_ptr = np.concatenate([[0], np.cumsum(np.maximum(deg_arr - cap, 0))])

    def dev(a, dt):
        return torch.as_tensor(np.ascontiguousarray(a, dt), device=device)

    return EllMatrix(
        values=dev(vals, dtype), cols=dev(cols, np.int32),
        slice_ptr=dev(slice_ptr, np.int32), tail_ptr=dev(tail_ptr, np.int32),
        tail_cols=dev(K.indices[~keep], np.int32), tail_values=dev(K.data[~keep], dtype),
        shape=(int(n_rows), int(n_cols)), cap=int(cap),
        width=int(width[0]) if n_slices and (width == width[0]).all() else 0,
    )


def ell_matvec_plain(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch y = A x in the kernel's order: each row's slots in
    order, then its tail, added into y one after another (`index_add_`)."""
    n_slots = A.values.shape[0]
    sid = torch.repeat_interleave(
        torch.arange(A.n_slices, device=x.device), (A.widths() * ELL_SLICE).long(),
        output_size=n_slots)
    lane = (torch.arange(n_slots, device=x.device) - A.slice_ptr.long()[sid]) % ELL_SLICE
    y = torch.zeros(A.n_slices * ELL_SLICE, dtype=A.values.dtype, device=x.device)
    y.index_add_(0, sid * ELL_SLICE + lane, A.values * x[A.cols.long()])
    trows = torch.repeat_interleave(
        torch.arange(A.n_rows, device=x.device), (A.tail_ptr[1:] - A.tail_ptr[:-1]).long(),
        output_size=A.tail_values.shape[0])
    y.index_add_(0, trows, A.tail_values * x[A.tail_cols.long()])
    return y[: A.n_rows]


def ell_spmv_cuda(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """Launch K6 on x's device and PyTorch's current stream: one launch,
    slots and tail; no sync."""
    if not x.is_cuda:
        raise ValueError(f"ell_spmv needs a CUDA tensor; got one on {x.device}")
    dtype = A.values.dtype
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ell_spmv: no kernel for {dtype} values")
    name = "ell_spmv_f64" if dtype == torch.float64 else "ell_spmv_f32"
    n_slots, n_tail = A.values.shape[0], A.tail_values.shape[0]
    for nm, t, dt, shape in (("values", A.values, dtype, (n_slots,)),
                             ("cols", A.cols, torch.int32, (n_slots,)),
                             ("slice_ptr", A.slice_ptr, torch.int32,
                              (-(-A.n_rows // ELL_SLICE) + 1,)),
                             ("tail_ptr", A.tail_ptr, torch.int32, (A.n_rows + 1,)),
                             ("tail_cols", A.tail_cols, torch.int32, (n_tail,)),
                             ("tail_values", A.tail_values, dtype, (n_tail,)),
                             ("x", x, dtype, (A.shape[1],))):
        if t.device != x.device or t.dtype != dt or not t.is_contiguous():
            raise ValueError(f"{name}: {nm} must be a contiguous {dt} tensor on {x.device}; "
                             f"got {t.dtype} on {t.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: {nm} has shape {tuple(t.shape)}, expected {shape}")
    y = torch.empty(A.n_rows, dtype=dtype, device=x.device)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    err = getattr(_library_ell(), name)(
        A.n_rows, A.width, n_tail, A.slice_ptr.data_ptr(), A.cols.data_ptr(), A.values.data_ptr(),
        A.tail_ptr.data_ptr(), A.tail_cols.data_ptr(), A.tail_values.data_ptr(),
        x.data_ptr(), y.data_ptr(), stream,
    )
    if err != 0:
        raise RuntimeError(f"{name} launch failed: cudaError_t {err}")
    LAUNCHES[name] += 1
    return y


def ell_matvec(A: EllMatrix, x: torch.Tensor) -> torch.Tensor:
    """y = A x on an ELL operator: K6 (f32 or f64) on a CUDA tensor, the
    plain version on a CPU tensor."""
    if x.is_cuda:
        return ell_spmv_cuda(A, x)
    if x.device.type != "cpu":
        raise ValueError(f"ell_matvec: no route for device {x.device}")
    if A.values.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"ell_matvec: no kernel for {A.values.dtype} values")
    LAUNCHES["ell_spmv_f64_plain" if A.values.dtype == torch.float64 else "ell_spmv_f32_plain"] += 1
    return ell_matvec_plain(A, x)


# ---------------------------------------------------------------------------
# row sharding
# ---------------------------------------------------------------------------
class RowShard(NamedTuple):
    """One rank's row slice of an operator (`shard_rows`).

    `local` is the slice in the operator's own format, with global columns:
    a `CsrMatrix` (its row blocks rebuilt), a `NodeBlockMatrix` (its
    `node_offset` and `col_nodes` set), a `NodeTransfer` or an `EllMatrix`
    (whole slices of ELL_SLICE rows, the tails of those rows).  Its output
    rows are row0 .. row0 + rows - 1 of the whole operator's; `counts` holds
    every rank's, in rank order.  `group` is the ranks'
    `parallel.sharding.ShardGroup`.  `entry0` is the slice's first stored
    entry in the whole operator's (CSR entry, node block, transfer entry or
    ELL slot): the tangent refresh shifts its global destinations by it."""

    local: object
    row0: int
    counts: Tuple[int, ...]
    group: object
    entry0: int = 0

    @property
    def rows(self) -> int:
        return self.counts[self.group.rank]

    @property
    def own(self) -> slice:
        """This rank's rows of a vector over the whole operator's rows."""
        return slice(self.row0, self.row0 + self.rows)

    @property
    def shape(self) -> Tuple[int, int]:
        return (sum(self.counts), self.local.shape[1])

    def gather(self, y_local: torch.Tensor) -> torch.Tensor:
        """Every rank's output rows concatenated: the whole product."""
        return self.group.gather(y_local, self.counts)


# each `_slice_*` returns (the slice's first stored entry, the slice) of
# rows or nodes [first, end)
def _parts(n_units: int, size: int) -> list:
    """[first, end) of each of `size` ranks over `n_units` units: ceil(n /
    size) each in order, the last ones shorter (or empty)."""
    per = -(-n_units // size)
    return [(min(r * per, n_units), min((r + 1) * per, n_units)) for r in range(size)]


def _host_int(t: torch.Tensor, i: int) -> int:
    return int(t[i].item())


def _slice_csr(A: CsrMatrix, r0: int, r1: int) -> Tuple[int, CsrMatrix]:
    p0, p1 = _host_int(A.indptr, r0), _host_int(A.indptr, r1)
    indptr = (A.indptr[r0:r1 + 1] - p0).contiguous()
    return p0, CsrMatrix(
        indptr=indptr, indices=A.indices[p0:p1].contiguous(), values=A.values[p0:p1].contiguous(),
        shape=(r1 - r0, A.shape[1]),
        row_blocks=torch.as_tensor(row_blocks(indptr.cpu().numpy()), device=A.indptr.device),
    )


def _slice_nodes(B: NodeBlockMatrix, k0: int, k1: int) -> Tuple[int, NodeBlockMatrix]:
    b0, b1 = _host_int(B.node_ptr, k0), _host_int(B.node_ptr, k1)
    node_ptr = (B.node_ptr[k0:k1 + 1] - b0).contiguous()
    per_node = (node_ptr[1:] - node_ptr[:-1])
    return b0, NodeBlockMatrix(
        node_ptr=node_ptr, block_cols=B.block_cols[b0:b1].contiguous(),
        block_values=B.block_values[b0:b1].contiguous(),
        width=int(per_node.max()) if k1 > k0 else 0,
        node_offset=B.node_offset + k0, col_nodes=B.shape[1] // 2,
    )


def _slice_transfer(T: NodeTransfer, k0: int, k1: int) -> Tuple[int, NodeTransfer]:
    e0, e1 = _host_int(T.node_ptr, k0), _host_int(T.node_ptr, k1)
    node_ptr = (T.node_ptr[k0:k1 + 1] - e0).contiguous()
    return e0, NodeTransfer(
        node_ptr=node_ptr, node_cols=T.node_cols[e0:e1].contiguous(),
        weights=T.weights[e0:e1].contiguous(), shape=(2 * (k1 - k0), T.shape[1]),
        width=int((node_ptr[1:] - node_ptr[:-1]).max()) if k1 > k0 else 0,
    )


def _slice_ell(A: EllMatrix, s0: int, s1: int) -> Tuple[int, EllMatrix]:
    r0, r1 = s0 * ELL_SLICE, min(s1 * ELL_SLICE, A.n_rows)
    p0, p1 = _host_int(A.slice_ptr, s0), _host_int(A.slice_ptr, s1)
    t0, t1 = _host_int(A.tail_ptr, r0), _host_int(A.tail_ptr, r1)
    slice_ptr = (A.slice_ptr[s0:s1 + 1] - p0).contiguous()
    widths = ((slice_ptr[1:] - slice_ptr[:-1]) // ELL_SLICE).cpu().numpy()
    return p0, A._replace(
        values=A.values[p0:p1].contiguous(), cols=A.cols[p0:p1].contiguous(),
        slice_ptr=slice_ptr, tail_ptr=(A.tail_ptr[r0:r1 + 1] - t0).contiguous(),
        tail_cols=A.tail_cols[t0:t1].contiguous(), tail_values=A.tail_values[t0:t1].contiguous(),
        shape=(r1 - r0, A.shape[1]),
        width=int(widths[0]) if widths.size and (widths == widths[0]).all() else 0,
    )


def shard_rows(A, group) -> RowShard:
    """This rank's `RowShard` of A (`shard_rows`, JAX `spmv.py:2033`): a
    `CsrMatrix` cut by rows, a `NodeBlockMatrix` or `NodeTransfer` by
    nodes (two rows each), an `EllMatrix` by slices of ELL_SLICE rows, so
    that no slice changes its width; ceil(units / ranks) units a rank, the
    last ranks' slices shorter.  Every row keeps its entries and their
    order, so each row's sum has the whole operator's bits; the gather pads
    the shorter slices for the transport only (`ShardGroup.gather`)."""
    if isinstance(A, RowShard):
        raise ValueError("shard_rows: the operator is sharded already")
    if isinstance(A, (NodeBlockMatrix, NodeTransfer)):
        unit, n_units = 2, A.n_nodes
        cut = _slice_nodes if isinstance(A, NodeBlockMatrix) else _slice_transfer
    elif isinstance(A, CsrMatrix):
        unit, n_units, cut = 1, A.n_rows, _slice_csr
    elif isinstance(A, EllMatrix):
        unit, n_units, cut = ELL_SLICE, A.n_slices, _slice_ell
    else:
        raise TypeError(f"shard_rows: no route for {type(A).__name__}")
    parts = _parts(n_units, group.size)
    n_rows = A.shape[0]
    counts = tuple(min(e * unit, n_rows) - min(f * unit, n_rows) for f, e in parts)
    first, end = parts[group.rank]
    entry0, local = cut(A, first, end)
    return RowShard(local=local, row0=min(first * unit, n_rows), counts=counts, group=group,
                    entry0=entry0)


def local_of(A):
    """A's format: this rank's slice of a RowShard, else A itself."""
    return A.local if isinstance(A, RowShard) else A


def block_values(A) -> torch.Tensor:
    """The node-block values of A, or of this rank's slice of it."""
    return local_of(A).block_values


def with_block_values(A, values: torch.Tensor):
    """A with new node-block values (this rank's slice's on a RowShard)."""
    if isinstance(A, RowShard):
        return A._replace(local=A.local._replace(block_values=values))
    return A._replace(block_values=values)


def sp_matvec(A, x: torch.Tensor) -> torch.Tensor:
    """Format-generic y = A x, by the operator's type: `CsrMatrix` through
    K1 (or the f32 CSR kernel), f32 `NodeBlockMatrix` through K3's
    product, `EllMatrix` through K6; a `RowShard` of one: its rows here,
    then the gather of every rank's."""
    if isinstance(A, RowShard):
        return A.gather(sp_matvec(A.local, x) if A.rows else x.new_zeros(0))
    if isinstance(A, NodeBlockMatrix):
        return node_block_matvec(A, x)
    if isinstance(A, CsrMatrix):
        return csr_matvec(A, x)
    if isinstance(A, EllMatrix):
        return ell_matvec(A, x)
    raise TypeError(f"sp_matvec: no route for {type(A).__name__}")


def residual_operators(geom, device, fmt: Optional[str] = None,
                       max_overflow_frac: float = 0.005):
    """The f64 strain and force operators (G, S) of `geom` (an
    `ops.assembly.Geometry`) on `device`: CSR (K1), or with fmt="ell"
    (`build_residual_slot_df(fmt="ell")`) each one sliced ELL operator
    (K6).  The JAX package splits S into three column parts, one a strain
    component, to fit its 128-lane window; the card has no window, and S
    stays one operator over all 3 n_int columns."""
    G, S = build_residual_csr(
        geom.B.cpu().numpy(), geom.weight.cpu().numpy(), geom.edofs.cpu().numpy(),
        geom.n_q, geom.n_nodes,
    )
    if fmt is None:
        return csr_to_device(G, device), csr_to_device(S, device)
    return (build_ell(G, device, np.float64, max_overflow_frac),
            build_ell(S, device, np.float64, max_overflow_frac))
