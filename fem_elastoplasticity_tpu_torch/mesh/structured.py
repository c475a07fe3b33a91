"""Mesh container and the footing's structured square mesh (host, NumPy).

Port of `fem_elastoplasticity_tpu/mesh/structured.py`: the `Mesh`
container (:29) and, for P1 elements, `square_mesh` (:77) with its
numbering helpers.  Node numbering is the reference's: 0-based, (y-major,
x-minor) over the grid nodes; each grid cell splits into the triangles
(V1, V2, V4), (V2, V3, V4).  The square-with-hole generator of the
elasticity problem and the higher-order families come with later slices.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from ..ops.elements import ElementType


@dataclass
class Mesh:
    """Unstructured 2D mesh container (host-side).

    Attributes:
      coords:    (n_n, 2) float64 node coordinates
      elems:     (n_e, n_p) int32 element connectivity, 0-based
      etype:     element family
      surface:   (n_s, n_p_s) boundary edge connectivity (all boundary edges)
      neumann:   (n_t, n_p_s) edges carrying traction (may be empty)
      dirichlet: (n_n, 2) float64 inhomogeneous Dirichlet magnitudes
      free:      (n_n, 2) bool mask of free (unknown) DOFs
    """

    coords: np.ndarray
    elems: np.ndarray
    etype: ElementType
    surface: Optional[np.ndarray] = None
    neumann: Optional[np.ndarray] = None
    dirichlet: Optional[np.ndarray] = None
    free: Optional[np.ndarray] = None

    @property
    def n_nodes(self) -> int:
        return self.coords.shape[0]

    @property
    def n_elems(self) -> int:
        return self.elems.shape[0]

    @property
    def n_free_dofs(self) -> int:
        return int(self.free.sum()) if self.free is not None else 2 * self.n_nodes


def _grid_numbering(nx: int, ny: int, keep: np.ndarray) -> np.ndarray:
    """Number kept grid nodes 0-based in (y-major, x-minor) order.

    `keep` is a boolean array of shape (nx+1, ny+1) indexed [ix, iy].
    Returns int array `num` of same shape with -1 at dropped nodes.
    """
    num = -np.ones((nx + 1, ny + 1), dtype=np.int64)
    keep_t = keep.T  # (iy, ix)
    idx = np.cumsum(keep_t.ravel()).reshape(keep_t.shape) - 1
    num.T[keep_t] = idx[keep_t]
    return num


def square_mesh(level: int, etype: ElementType, size_xy: float) -> Mesh:
    """Structured P1 mesh of the [0, size_xy]^2 square (footing domain).

    Numbering as `Plasticity2D_DP/pythonFEM.py` `get_nodes_1` (:63-186).
    """
    if etype != ElementType.P1:
        raise NotImplementedError(f"{etype} structured square mesh")
    N = int(size_xy * 2**level)
    keep = np.ones((N + 1, N + 1), dtype=bool)
    num = _grid_numbering(N, N, keep)

    xs = np.linspace(0.0, size_xy, N + 1)
    iy_t, ix_t = np.nonzero(keep.T)  # C-order over (iy, ix) = y-major
    coords = np.stack([xs[ix_t], xs[iy_t]], axis=1)

    elems = _cells_to_elems(num, N)
    surface, neumann = _square_surface(num, N)
    return Mesh(coords, elems, etype, surface=surface, neumann=neumann)


def _cells_to_elems(num: np.ndarray, N: int) -> np.ndarray:
    """P1 connectivity: cells visited (cy-major, cx-minor), each split into
    (V1, V2, V4), (V2, V3, V4) with V1=(cx,cy) V2=(cx+1,cy) V3=(cx+1,cy+1)
    V4=(cx,cy+1)."""
    cy, cx = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    cx, cy = cx.ravel(), cy.ravel()

    def at(dx, dy):
        return num[cx + dx, cy + dy]

    t1 = np.stack([at(0, 0), at(1, 0), at(0, 1)], axis=1)
    t2 = np.stack([at(1, 0), at(1, 1), at(0, 1)], axis=1)
    elems = np.stack([t1, t2], axis=1).reshape(-1, 3)
    assert (elems >= 0).all(), "element references dropped node"
    return elems.astype(np.int32)


def _edge_nodes(num: np.ndarray, fixed_axis: int, fixed_idx: int, lo: int, hi: int) -> np.ndarray:
    """Two-node edges along one side of the grid between indices [lo, hi]."""
    idx = np.arange(lo, hi + 1)
    line = num[fixed_idx, idx] if fixed_axis == 0 else num[idx, fixed_idx]
    return np.stack([line[:-1], line[1:]], axis=1).astype(np.int32)


def _square_surface(num: np.ndarray, N: int):
    bottom = _edge_nodes(num, 1, 0, 0, N)
    right = _edge_nodes(num, 0, N, 0, N)
    top = _edge_nodes(num, 1, N, 0, N)
    left = _edge_nodes(num, 0, 0, 0, N)
    surface = np.concatenate([bottom, right, top, left], axis=0)
    return surface, top
