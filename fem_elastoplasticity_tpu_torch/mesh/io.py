"""CSV mesh files in the reference's format (host, NumPy).

Port of `fem_elastoplasticity_tpu/mesh/io.py`: `coord.csv` holds the node
coordinates as two comma-separated rows (x, then y) and `elem.csv` the P1
connectivity as three rows of 1-based node indices
(`tsx-tunnel/pythonFEM.py:1687-1688`).
"""
from __future__ import annotations

import numpy as np

from ..ops.elements import ElementType
from .structured import Mesh


def load_csv_mesh(coord_path: str, elem_path: str) -> Mesh:
    """A P1 triangle mesh from the reference's CSV files, with 0-based int32
    connectivity."""
    coords = np.genfromtxt(coord_path, delimiter=",", dtype=np.float64)
    elems = np.genfromtxt(elem_path, delimiter=",", dtype=np.int64) - 1
    if coords.shape[0] == 2:  # rows are x / y
        coords = coords.T
    if elems.shape[0] == 3:
        elems = elems.T
    return Mesh(np.ascontiguousarray(coords), elems.astype(np.int32), ElementType.P1)


def save_csv_mesh(mesh: Mesh, coord_path: str, elem_path: str) -> None:
    """Write a P1 mesh in the reference's CSV format (1-based)."""
    np.savetxt(coord_path, mesh.coords.T, delimiter=",")
    np.savetxt(elem_path, (mesh.elems.T + 1).astype(np.int64), delimiter=",", fmt="%d")
