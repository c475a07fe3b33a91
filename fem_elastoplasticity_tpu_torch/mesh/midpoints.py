"""Edge-midpoint insertion on unstructured triangle meshes (host-side).

Port of `fem_elastoplasticity_tpu/mesh/midpoints.py`: the P2 midpoint
numbering that uniform refinement is built on, the P4 node insertion, and
`promote` to P1, P2 and P4 triangles.

Numbering contract (P2): scanning elements in order, edges in local order
(V2,V3), (V3,V1), (V1,V2); each previously-unseen undirected edge gets the
next node number.  The local connectivity order is
[V1, V2, V3, mid(V2V3), mid(V3V1), mid(V1V2)].
"""
from __future__ import annotations

from typing import Tuple

import numpy as np

from ..ops.elements import ElementType


def _edge_scan(directed: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """First-occurrence numbering of undirected edges in scan order.

    Args:
      directed: (n_slots, 2) directed edges in scan order.

    Returns:
      owner_rank: (n_unique,) for each unique edge, its first-occurrence
                  position in the scan.
      edge_id:    (n_slots,) index of the unique edge for each slot, where
                  unique edges are numbered 0..n_unique-1 in scan
                  (first-occurrence) order.
      is_owner:   (n_slots,) True where the slot is the first occurrence.
    """
    lo = directed.min(axis=1)
    hi = directed.max(axis=1)
    keys = lo.astype(np.int64) * (hi.max() + 1) + hi
    _, first_pos, inverse = np.unique(keys, return_index=True, return_inverse=True)
    order = np.argsort(first_pos, kind="stable")
    rank = np.empty_like(order)
    rank[order] = np.arange(len(order))
    edge_id = rank[inverse]
    is_owner = np.zeros(len(directed), dtype=bool)
    is_owner[first_pos] = True
    return first_pos[order], edge_id, is_owner


def insert_midpoints_p2(coords: np.ndarray, elems: np.ndarray):
    """P1 -> P2: add one midpoint per edge.

    Args:
      coords: (n_n, 2) vertex coordinates.
      elems:  (n_e, 3) triangle connectivity.

    Returns:
      (coords_ext (n_n+n_edges, 2), elems_ext (n_e, 6) int32)
    """
    n_n = coords.shape[0]
    n_e = elems.shape[0]
    directed = np.stack(
        [
            np.stack([elems[:, 1], elems[:, 2]], axis=1),
            np.stack([elems[:, 2], elems[:, 0]], axis=1),
            np.stack([elems[:, 0], elems[:, 1]], axis=1),
        ],
        axis=1,
    ).reshape(-1, 2)
    first_pos, edge_id, _ = _edge_scan(directed)
    owners = directed[first_pos]  # (n_edges, 2) in owner orientation
    mids = 0.5 * (coords[owners[:, 0]] + coords[owners[:, 1]])
    coords_ext = np.concatenate([coords, mids], axis=0)
    mid_nodes = (n_n + edge_id).reshape(n_e, 3)
    elems_ext = np.concatenate([elems, mid_nodes], axis=1)
    return coords_ext, elems_ext.astype(np.int32)


def insert_midpoints_p4(coords: np.ndarray, elems: np.ndarray):
    """P1 -> P4: 3 interior nodes per element + 3 nodes per edge.

    Args:
      coords: (n_n, 2) vertex coordinates.
      elems:  (n_e, 3) triangle connectivity (consistently oriented).

    Returns:
      (coords_ext, elems_ext (n_e, 15) int32) with the local order
      [V1, V2, V3, m12, m23, m31, q12 near V1, q12 near V2, q23 near V2,
      q23 near V3, q31 near V3, q31 near V1, 3 interior nodes].
    """
    n_n = coords.shape[0]
    n_e = elems.shape[0]
    v0, v1, v2 = elems[:, 0], elems[:, 1], elems[:, 2]

    # scan order per element: edges (V1,V2), (V2,V3), (V3,V1)
    directed = np.stack(
        [np.stack([v0, v1], axis=1), np.stack([v1, v2], axis=1), np.stack([v2, v0], axis=1)],
        axis=1,
    )  # (n_e, 3, 2)
    flat = directed.reshape(-1, 2)
    first_pos, edge_id, is_owner = _edge_scan(flat)
    owns = is_owner.reshape(n_e, 3)

    # new nodes per element, in order: 3 interior, then 3 for each edge it
    # owns (V1V2, V2V3, V3V1)
    per_elem = 3 + 3 * owns.sum(axis=1)
    elem_base = n_n + np.concatenate([[0], np.cumsum(per_elem)[:-1]])
    interior = elem_base[:, None] + np.arange(3)[None, :]  # (n_e, 3)

    # base of each owned edge's 3-node group within its element
    own_rank = np.cumsum(owns, axis=1) - owns
    edge_group_base = elem_base[:, None] + 3 + 3 * own_rank
    edge_base = np.zeros(len(first_pos), dtype=np.int64)
    edge_base[edge_id.reshape(n_e, 3)[owns]] = edge_group_base[owns]

    eid = edge_id.reshape(n_e, 3)
    mid = edge_base[eid]  # the midpoint node of each slot
    owners = flat[first_pos]  # owner orientation (a, b) of each edge
    # the quarter node near the slot's first vertex: base+1 where that is
    # the owner's a, base+2 where it is the owner's b
    slot_a = directed[:, :, 0]
    near_first = np.where(owners[eid][:, :, 0] == slot_a, mid + 1, mid + 2)
    near_second = np.where(owners[eid][:, :, 0] == slot_a, mid + 2, mid + 1)

    elems_ext = np.concatenate(
        [
            elems,
            mid,
            np.stack(
                [near_first[:, 0], near_second[:, 0], near_first[:, 1],
                 near_second[:, 1], near_first[:, 2], near_second[:, 2]],
                axis=1,
            ),
            interior,
        ],
        axis=1,
    ).astype(np.int32)

    n_new = int(per_elem.sum())
    new_coords = np.zeros((n_new, 2))
    ca, cb, cc = coords[v0], coords[v1], coords[v2]
    new_coords[interior[:, 0] - n_n] = ca / 2 + cb / 4 + cc / 4
    new_coords[interior[:, 1] - n_n] = ca / 4 + cb / 2 + cc / 4
    new_coords[interior[:, 2] - n_n] = ca / 4 + cb / 4 + cc / 2
    pa = coords[owners[:, 0]]
    pb = coords[owners[:, 1]]
    new_coords[edge_base - n_n] = (pa + pb) / 2
    new_coords[edge_base + 1 - n_n] = 3 * pa / 4 + pb / 4
    new_coords[edge_base + 2 - n_n] = pa / 4 + 3 * pb / 4
    return np.concatenate([coords, new_coords], axis=0), elems_ext


def promote(etype: ElementType, coords: np.ndarray, elems: np.ndarray):
    """Promote a P1 triangle mesh to `etype` (P1 pass-through, P2 or P4)."""
    if elems.ndim != 2 or elems.shape[1] != 3:
        raise ValueError(
            f"promote expects P1 triangle connectivity (n_e, 3); got {elems.shape}"
        )
    if etype == ElementType.P1:
        return coords, elems.astype(np.int32)
    if etype == ElementType.P2:
        return insert_midpoints_p2(coords, elems)
    if etype == ElementType.P4:
        return insert_midpoints_p4(coords, elems)
    raise NotImplementedError(f"promotion to {etype}")
