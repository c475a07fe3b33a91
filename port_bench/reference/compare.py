"""The numbers that decide whether an answer of the port is correct.

`Mapped` places the port's answer on the reference's own mesh: each of
the port's nodes is matched to a reference node by its coordinates and each
of its triangles to a reference triangle by its three nodes, both one to
one, or the answer is refused (`LayoutError`).  `numbers` then computes, in
float64 from the reference's own geometry and material:

  schedule_faults   rules the accepted load factors break (exact: 0)
  bc_gap            max |u - prescribed| on the constrained DOFs / max |u|
  eq_residual       |F_int(s)| on the free DOFs / |F_int(s)| on the
                    constrained ones, s = D (e(u) + zeta e0 - ep): the
                    port's final displacement and plastic strain in
                    equilibrium
  yield_excess      max(0, f(s)) / c_dp over the points: s admissible
  return_map_gap    (where the plastic strain before the answer's last load
                    trip is known) max |ep_ref - ep| / max |ep|, ep_ref
                    the reference return map of e(u) from that strain

and `resume_gap` holds two answers of one solve to each other (exact: 0).
`control` rounds an answer's displacement and plastic strain to float32:
the best that a solver which keeps its state in float32 could hand back.
"""
from __future__ import annotations

import numpy as np
from scipy.spatial import cKDTree

from .fem import P1, elastic_stress, return_map, total_strain


class LayoutError(ValueError):
    """The port's mesh is not the reference's mesh."""


class Mapped:
    """The reference mesh's geometry and the port's layout on it."""

    def __init__(self, problem, port_coords: np.ndarray, port_elems: np.ndarray):
        ref_c = problem.coords
        if port_coords.shape != ref_c.shape or port_elems.shape != problem.elems.shape:
            raise LayoutError(f"the port's mesh has {port_coords.shape[0]} nodes and "
                              f"{port_elems.shape[0]} triangles, the reference "
                              f"{ref_c.shape[0]} and {problem.elems.shape[0]}")
        scale = np.abs(ref_c).max()
        dist, node = cKDTree(ref_c).query(np.asarray(port_coords, np.float64))
        if dist.max() > 1e-9 * scale or np.unique(node).size != node.size:
            raise LayoutError("the port's nodes do not match the reference's one to one")
        self.node = node                      # reference node of each port node
        n = ref_c.shape[0]

        def keys(e):
            e = np.sort(np.asarray(e, np.int64), axis=1)
            return (e[:, 0] * n + e[:, 1]) * n + e[:, 2]

        kp, kr = keys(node[np.asarray(port_elems)]), keys(problem.elems)
        op, orf = np.argsort(kp), np.argsort(kr)
        if not np.array_equal(kp[op], kr[orf]) or np.unique(kr).size != kr.size:
            raise LayoutError("the port's triangles do not match the reference's one to one")
        self.elem = np.empty(kp.size, np.int64)   # reference triangle of each port one
        self.elem[op] = orf
        self.n_elems = kp.size
        self.geo = P1(ref_c, problem.elems)

    def nodal(self, x_port: np.ndarray) -> np.ndarray:
        out = np.empty((self.node.size, 2))
        out[self.node] = np.asarray(x_port, np.float64).reshape(-1, 2)
        return out

    def points(self, ep_port: np.ndarray) -> np.ndarray:
        """(4, n_e) in the reference order; columns past the port's
        triangles (padding) must be zero."""
        ep_port = np.asarray(ep_port, np.float64)
        if np.any(ep_port[:, self.n_elems:] != 0.0):
            raise LayoutError("the port's padding points carry plastic strain")
        out = np.empty((4, self.n_elems))
        out[:, self.elem] = ep_port[:, :self.n_elems]
        return out


def numbers(problem, mapped: Mapped, answer: dict, start=None, final: bool = True) -> dict:
    """The comparison of one answer (module doc).  `start`: the plastic
    strain before the answer's last load trip, on the port's layout, or
    None; `final`: the answer ends the request, so its schedule is held to
    the problem's (an answer part way along it is judged by its state)."""
    u = mapped.nodal(answer["u"])
    ep = mapped.points(answer["ep"])
    zeta = float(answer["zeta"])
    out = {"schedule_faults": problem.schedule_faults(answer)} if final else {}
    g = problem.prescribed(zeta)
    fixed = ~problem.free
    out["bc_gap"] = float(np.abs(u - g)[fixed].max() / max(np.abs(u).max(), 1e-300))
    e4 = total_strain(mapped.geo, u, problem.eigenstrain(zeta))
    _, _, f_tr = return_map(e4, ep, problem.shear, problem.bulk, problem.eta, problem.c_dp)
    f = mapped.geo.force(elastic_stress(e4 - ep, problem.shear, problem.bulk))
    out["eq_residual"] = float(np.linalg.norm(f[problem.free]) / np.linalg.norm(f[fixed]))
    out["yield_excess"] = float(max(f_tr.max(), 0.0) / problem.c_dp)
    if start is not None:
        _, ep_ref, _ = return_map(e4, mapped.points(start), problem.shear, problem.bulk,
                                  problem.eta, problem.c_dp)
        out["return_map_gap"] = float(np.abs(ep_ref - ep).max()
                                     / max(np.abs(ep).max(), 1e-300))
    return out


def resume_gap(a: dict, b: dict) -> float:
    """max |a - b| over u and ep, over max |b| of each; inf where their
    accepted load factors differ."""
    if a["n_steps"] != b["n_steps"] or not np.array_equal(a["zeta_hist"], b["zeta_hist"]):
        return float("inf")
    return max(float(np.abs(np.asarray(a[k]) - np.asarray(b[k])).max()
                     / max(np.abs(np.asarray(b[k])).max(), 1e-300)) for k in ("u", "ep"))


def control(answer: dict) -> dict:
    """The answer with u and ep rounded to float32 (module doc)."""
    low = dict(answer)
    for k in ("u", "ep"):
        low[k] = np.asarray(answer[k]).astype(np.float32).astype(np.float64)
    return low
