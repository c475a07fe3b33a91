"""Boundary edges of an unstructured triangle mesh (host, NumPy).

Port of `fem_elastoplasticity_tpu/mesh/boundary.py`: the edges that belong
to exactly one triangle, with their higher-order nodes, so that traction
loads (`ops.assembly.traction_force_vector`) work on any P1, P2 or P4 mesh.
"""
from __future__ import annotations

import numpy as np

from ..ops.elements import ElementType


def boundary_edges(elems: np.ndarray, etype: ElementType = ElementType.P1) -> np.ndarray:
    """Edges of exactly one triangle, oriented as in their element.

    elems: (n_e, n_p) connectivity, P1 (3), P2 (6) or P4 (15) as
    `mesh.midpoints.promote` lays them out.  Returns (n_b, n_p_s) int32:
    [end0, end1] (P1), [end0, end1, mid] (P2) or [end0, end1, mid,
    quarter near end0, quarter near end1] (P4).
    """
    elems = np.asarray(elems)
    v = elems[:, :3]
    # local edges in element orientation: (V1,V2), (V2,V3), (V3,V1)
    directed = np.stack([v[:, [0, 1]], v[:, [1, 2]], v[:, [2, 0]]], axis=1).reshape(-1, 2)
    lo = directed.min(axis=1).astype(np.int64)
    hi = directed.max(axis=1).astype(np.int64)
    _, inverse, counts = np.unique(lo * (hi.max() + 1) + hi, return_inverse=True,
                                   return_counts=True)
    slot = np.nonzero(counts[inverse] == 1)[0]
    e_idx, l_idx = slot // 3, slot % 3
    ends = directed[slot]

    if etype == ElementType.P1 or elems.shape[1] == 3:
        return ends.astype(np.int32)
    if elems.shape[1] == 6:  # P2: columns 3..5 are m23, m31, m12
        mids = elems[e_idx, np.array([5, 3, 4])[l_idx]]
        return np.concatenate([ends, mids[:, None]], axis=1).astype(np.int32)
    if elems.shape[1] == 15:  # P4 (mesh/midpoints.py layout)
        extra = np.stack([
            elems[e_idx, np.array([3, 4, 5])[l_idx]],
            elems[e_idx, np.array([6, 8, 10])[l_idx]],  # quarter near the first end
            elems[e_idx, np.array([7, 9, 11])[l_idx]],
        ], axis=1)
        return np.concatenate([ends, extra], axis=1).astype(np.int32)
    raise NotImplementedError(f"boundary extraction for n_p={elems.shape[1]}")
