"""Mesh container and the structured meshes of the benchmarks (host, NumPy).

Port of `fem_elastoplasticity_tpu/mesh/structured.py`: the `Mesh`
container (:29), `square_mesh` (:77, the footing's square) and
`square_with_hole_mesh` (:108, the elasticity problem's square with a
square hole in the lower-left corner), for P1, P2, Q1 and Q2 elements.
Node numbering is the reference's: 0-based, (y-major, x-minor) over the
kept grid nodes; quadratic elements refine the grid twice and Q2 drops the
cell centres.  Each P1 grid cell splits into the triangles (V1, V2, V4),
(V2, V3, V4).
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


def _grid(etype: ElementType, N: int):
    """(grid segments a side, grid step of a cell) of an element family."""
    if etype in (ElementType.P1, ElementType.Q1):
        return N, 1
    if etype in (ElementType.P2, ElementType.Q2):
        return 2 * N, 2
    raise NotImplementedError(f"{etype} structured mesh")


def _grid_coords(keep: np.ndarray, size_xy: float) -> np.ndarray:
    """Coordinates of the kept grid nodes in numbering order (y-major)."""
    xs = np.linspace(0.0, size_xy, keep.shape[0])
    iy_t, ix_t = np.nonzero(keep.T)  # C-order over (iy, ix) = y-major
    return np.stack([xs[ix_t], xs[iy_t]], axis=1)


def square_mesh(level: int, etype: ElementType, size_xy: float) -> Mesh:
    """Structured mesh of the [0, size_xy]^2 square (footing domain).

    Numbering as `Plasticity2D_DP/pythonFEM.py` `get_nodes_1` (P1/Q1,
    :63-186) and `get_nodes_2` (P2/Q2, :189-343).
    """
    N = int(size_xy * 2**level)
    g, step = _grid(etype, N)
    keep = np.ones((g + 1, g + 1), dtype=bool)
    if etype == ElementType.Q2:
        keep[1::2, 1::2] = False  # drop cell centres (serendipity)
    num = _grid_numbering(g, g, keep)
    elems = _cells_to_elems(num, N, step, etype, hole=None)
    surface, neumann = _square_surface(num, N, step)
    return Mesh(_grid_coords(keep, size_xy), elems, etype, surface=surface, neumann=neumann)


def square_with_hole_mesh(level: int, etype: ElementType, size_xy: float,
                          size_hole: float) -> Mesh:
    """Square with a square hole in the lower-left corner (elasticity
    domain): nodes with x < size_hole and y < size_hole are removed.

    Numbering as `Elasticity2D/pythonFEM.py` `get_nodes_1` (:481-660) and
    `get_nodes_2` (:663-922).
    """
    N = int(size_xy * 2**level)
    N1 = int(size_hole * 2**level)
    g, step = _grid(etype, N)
    keep = np.ones((g + 1, g + 1), dtype=bool)
    keep[:step * N1, :step * N1] = False  # the hole
    if etype == ElementType.Q2:
        keep[1::2, 1::2] = False
    num = _grid_numbering(g, g, keep)
    elems = _cells_to_elems(num, N, step, etype, hole=N1)
    surface, neumann = _hole_surface(num, N, N1, step)
    return Mesh(_grid_coords(keep, size_xy), elems, etype, surface=surface, neumann=neumann)


def _cells_to_elems(num: np.ndarray, N: int, step: int, etype: ElementType,
                    hole) -> np.ndarray:
    """Element connectivity from the grid numbering.

    Cells are visited (cy-major, cx-minor), without the hole's cells (cx <
    hole and cy < hole) if `hole` is given; each cell has the corners
    V1=(cx,cy) V2=(cx+1,cy) V3=(cx+1,cy+1) V4=(cx,cy+1) in cell units.  P1
    splits it into (V1, V2, V4), (V2, V3, V4); P2 does the same with the
    local order [a, b, c, mid(b,c), mid(c,a), mid(a,b)]; Q1 and Q2 take the
    corners counter-clockwise, Q2 then the edge midpoints of V1V2, V2V3,
    V3V4, V4V1.
    """
    cy, cx = np.meshgrid(np.arange(N), np.arange(N), indexing="ij")
    cx, cy = cx.ravel(), cy.ravel()
    if hole is not None:
        mask = ~((cx < hole) & (cy < hole))
        cx, cy = cx[mask], cy[mask]
    gx, gy = step * cx, step * cy  # lower-left grid index of the cell

    def at(dx, dy):
        return num[gx + dx, gy + dy]

    if etype == ElementType.P1:
        t1 = np.stack([at(0, 0), at(1, 0), at(0, 1)], axis=1)
        t2 = np.stack([at(1, 0), at(1, 1), at(0, 1)], axis=1)
        elems = np.stack([t1, t2], axis=1).reshape(-1, 3)
    elif etype == ElementType.Q1:
        elems = np.stack([at(0, 0), at(1, 0), at(1, 1), at(0, 1)], axis=1)
    elif etype == ElementType.P2:
        t1 = np.stack([at(0, 0), at(2, 0), at(0, 2), at(1, 1), at(0, 1), at(1, 0)], axis=1)
        t2 = np.stack([at(2, 0), at(2, 2), at(0, 2), at(1, 2), at(1, 1), at(2, 1)], axis=1)
        elems = np.stack([t1, t2], axis=1).reshape(-1, 6)
    elif etype == ElementType.Q2:
        elems = np.stack([at(0, 0), at(2, 0), at(2, 2), at(0, 2),
                          at(1, 0), at(2, 1), at(1, 2), at(0, 1)], axis=1)
    else:
        raise NotImplementedError(etype)
    assert (elems >= 0).all(), "element references dropped node"
    return elems.astype(np.int32)


def _edge_nodes(num: np.ndarray, fixed_axis: int, fixed_idx: int, lo: int, hi: int,
                step: int) -> np.ndarray:
    """Edges along one side of the grid between grid indices [lo, hi]:
    (n_edges, n_p_s) with columns [end0, end1, midpoint (step 2)]."""
    idx = np.arange(lo, hi + 1)
    line = num[fixed_idx, idx] if fixed_axis == 0 else num[idx, fixed_idx]
    if step == 1:
        e = np.stack([line[:-1], line[1:]], axis=1)
    else:
        e = np.stack([line[:-1:2], line[2::2], line[1::2]], axis=1)
    return e.astype(np.int32)


def _square_surface(num: np.ndarray, N: int, step: int):
    g = step * N
    bottom = _edge_nodes(num, 1, 0, 0, g, step)
    right = _edge_nodes(num, 0, g, 0, g, step)
    top = _edge_nodes(num, 1, g, 0, g, step)
    left = _edge_nodes(num, 0, 0, 0, g, step)
    return np.concatenate([bottom, right, top, left], axis=0), top


def _hole_surface(num: np.ndarray, N: int, N1: int, step: int):
    g, h = step * N, step * N1
    faces = (
        _edge_nodes(num, 1, 0, h, g, step),  # y = 0, x in [hole, L]
        _edge_nodes(num, 0, g, 0, g, step),  # x = L
        _edge_nodes(num, 1, g, 0, g, step),  # y = L: the traction face
        _edge_nodes(num, 0, 0, h, g, step),  # x = 0, y in [hole, L]
        _edge_nodes(num, 1, h, 0, h, step),  # y = hole, x in [0, hole]
        _edge_nodes(num, 0, h, 0, h, step),  # x = hole, y in [0, hole]
    )
    return np.concatenate(faces, axis=0), faces[2]
