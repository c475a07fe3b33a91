"""The TSX tunnel excavation, worked out from its published inputs.

Source: FEM-ElastoPlasticity `tsx-tunnel/pythonFEM.py:1637-1851`.  The
mesh is the experiment's triangulation (`data/tsx_tunnel_mesh.npz`: the
reference's `coord.csv` / `elem.csv`, 476 nodes, 887 triangles), refined
uniformly through the edge midpoints; the normal displacement is clamped on
the +-50 m box; the in-situ stress s0 enters as the eigenstrain zeta e0 of
the inverse plane-strain Hooke law, released over the load factor zeta; no
external force.  The excavation ramps zeta to 1 in steps of 1/17, halving a
step whose Newton iteration fails.
"""
from __future__ import annotations

import math
import pathlib

import numpy as np

from .fem import dp_fit, lame

MESH = pathlib.Path(__file__).parent / "data" / "tsx_tunnel_mesh.npz"


def refine(coords: np.ndarray, elems: np.ndarray):
    """One uniform refinement: every triangle into four through its edge
    midpoints, each new node once."""
    n = coords.shape[0]
    edges = np.concatenate([elems[:, [0, 1]], elems[:, [1, 2]], elems[:, [2, 0]]])
    edges = np.sort(edges, axis=1)
    uniq, inv = np.unique(edges, axis=0, return_inverse=True)
    mids = n + inv.reshape(3, -1)            # m01, m12, m20 of each triangle
    new_coords = np.vstack([coords, 0.5 * (coords[uniq[:, 0]] + coords[uniq[:, 1]])])
    v0, v1, v2 = elems.T
    m01, m12, m20 = mids
    children = np.stack([np.stack([v0, m01, m20], 1), np.stack([v1, m12, m01], 1),
                         np.stack([v2, m20, m12], 1), np.stack([m01, m12, m20], 1)], 1)
    return new_coords, children.reshape(-1, 3)


class Problem:
    """Mesh, constraints, load and material of one request."""

    def __init__(self, config: dict, material: dict, root=None):
        with np.load(MESH) as raw:
            coords = raw["coords"].astype(np.float64)
            elems = raw["elems"].astype(np.int64)
        for _ in range(int(config["refine_levels"])):
            coords, elems = refine(coords, elems)
        self.coords, self.elems = coords, elems
        self.free = np.ones(coords.shape, dtype=bool)
        self.free[np.abs(coords[:, 0]) > 49.99, 0] = False
        self.free[np.abs(coords[:, 1]) > 49.99, 1] = False
        self.shear, self.bulk = lame(config["young"], config["poisson"])
        self.eta, self.c_dp = dp_fit(material["cohesion"],
                                     math.radians(material["friction_angle_deg"]))
        s0 = np.asarray(config["init_stress"], np.float64)
        nu, young = config["poisson"], config["young"]
        tr = s0[0] + s0[1] + s0[3]
        self.e0_dir = np.array([-nu * tr + (1 + nu) * s0[0], -nu * tr + (1 + nu) * s0[1], 0.0,
                                -nu * tr + (1 + nu) * s0[3]]) / young
        self.d_zeta = 1.0 / config["load_steps"]
        self.zeta_max = 1.0

    def eigenstrain(self, zeta: float):
        return zeta * self.e0_dir

    def prescribed(self, zeta: float) -> np.ndarray:
        """(n_n, 2) displacement of the constrained DOFs: clamped."""
        return np.zeros_like(self.coords)

    def start(self):
        """The plastic strain before the request's last load trip, where the
        reference knows it: None, since it lies 16 steps along the path.
        The check takes the port's own (its entry's `split`) and judges
        that state apart."""
        return None

    def schedule_faults(self, answer: dict) -> int:
        """Rules the accepted load factors must keep: increasing, no step
        longer than 1/17, the last one at zeta = 1 (the controller's 1e-12
        stop slack), at least 17 steps."""
        z = np.asarray(answer["zeta_hist"], np.float64)
        faults = int(len(z) != answer["n_steps"])
        steps = np.diff(np.concatenate([[0.0], z]))
        faults += int(np.sum((steps <= 0.0) | (steps > self.d_zeta * (1.0 + 1e-12))))
        faults += int(len(z) == 0 or z[-1] < self.zeta_max - 1e-12)
        faults += int(len(z) < round(self.zeta_max / self.d_zeta))
        faults += int(len(z) > 0 and answer["zeta"] != z[-1])
        return faults
