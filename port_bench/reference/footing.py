"""The strip footing, worked out from its published inputs, and one load
trip resumed from a banked state.

Source: matlabfem (arXiv:1805.04155) and FEM-ElastoPlasticity
`Plasticity2D_DP/pythonFEM.py:901-1157`: the square [0, 10]^2 on a
structured grid of 10 * 2^level cells a side, each cell split along the
diagonal from its lower-right to its upper-left corner; a rigid footing
pushed down on the top edge for x <= 1 (its vertical displacement is
-zeta), the symmetry axis x = 0 and the far side x = 10 held horizontally,
the bottom y = 0 held vertically; no body or surface force.

The request resumes the load path from a banked state (the checkpoint
file, float32 hi/lo pairs that sum to the float64 values): one load trip
at zeta + d_zeta.  The state's arrays are stored in the solver's node and
element order, which `compare` maps onto this mesh.
"""
from __future__ import annotations

import math
import pathlib

import numpy as np

from .fem import dp_fit, lame


def _pair(raw, key):
    """A value of the checkpoint: its exact float64 copy where the file has
    one, else the sum of its float32 hi/lo pair, else the array itself."""
    if key + "__f64__lo" in raw.files:
        return raw[key + "__f64__lo"].astype(np.float64)
    if key + "__hi" in raw.files:
        return raw[key + "__hi"].astype(np.float64) + raw[key + "__lo"].astype(np.float64)
    return raw[key].astype(np.float64)


class Problem:
    """Mesh, constraints, load, material and banked start of one request."""

    def __init__(self, config: dict, material: dict, root):
        size = float(config["size_xy"])
        n = int(round(size * 2 ** int(config["level"])))
        ix, iy = np.meshgrid(np.arange(n + 1), np.arange(n + 1), indexing="xy")
        self.coords = np.stack([ix.ravel(), iy.ravel()], 1) * (size / n)
        node = lambda i, j: j * (n + 1) + i  # noqa: E731
        ci, cj = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
        ci, cj = ci.ravel(), cj.ravel()
        v1, v2 = node(ci, cj), node(ci + 1, cj)
        v3, v4 = node(ci + 1, cj + 1), node(ci, cj + 1)
        self.elems = np.concatenate([np.stack([v1, v2, v4], 1), np.stack([v2, v3, v4], 1)])
        x, y = self.coords[:, 0], self.coords[:, 1]
        self.footing = (y == size) & (x <= 1.0001)
        self.free = np.ones(self.coords.shape, dtype=bool)
        self.free[x == 0.0, 0] = False
        self.free[x == size, 0] = False
        self.free[y == 0.0, 1] = False
        self.free[self.footing, 1] = False
        self.shear, self.bulk = lame(config["young"], config["poisson"])
        self.eta, self.c_dp = dp_fit(material["cohesion"],
                                     math.radians(material["friction_angle_deg"]))
        with np.load(pathlib.Path(root) / config["checkpoint"]) as raw:
            self.ep_start = _pair(raw, "ep")
            self.zeta_start = float(_pair(raw, "zeta_old"))
            self.d_zeta_start = float(_pair(raw, "d_zeta"))
            self.step_start = int(raw["step"])
            self.hist_start = _pair(raw, "zeta_hist")

    def eigenstrain(self, zeta: float):
        return None

    def prescribed(self, zeta: float) -> np.ndarray:
        g = np.zeros_like(self.coords)
        g[self.footing, 1] = -zeta
        return g

    def start(self):
        """The plastic strain before the request's last (and only) load
        trip: the banked one, in the solver's element order."""
        return self.ep_start

    def schedule_faults(self, answer: dict) -> int:
        """The trip is accepted at exactly zeta_start + d_zeta_start, after
        the banked history, which it leaves as it was."""
        z = np.asarray(answer["zeta_hist"], np.float64)
        k = self.step_start - 1          # accepted steps in the banked history
        faults = int(answer["n_steps"] != k + 1) + int(len(z) != k + 1)
        faults += int(len(z) < k or not np.array_equal(z[:k], self.hist_start[1:k + 1]))
        expect = self.zeta_start + self.d_zeta_start
        faults += int(len(z) != k + 1 or z[-1] != expect or answer["zeta"] != expect)
        return faults
