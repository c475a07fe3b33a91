"""Visualization: mesh, deformed shapes, nodal fields, load curves.

Port of `fem_elastoplasticity_tpu/viz.py` on the port's `Mesh`
(`mesh/structured.py`) and results (`TsxResult`, `FootingResult`,
`ElasticityResult`: numpy arrays at the API edge); it draws the same
collections as the JAX module.  Functional parity with the reference's
matplotlib drawing layer (`draw_mesh` E:945-987, `draw_displacement`
E:990-1048, `draw_quantity` P:864-898 / T:1329-1351, load-displacement
curve T:1839-1842), redesigned around `matplotlib.collections` (one
PolyCollection instead of one Polygon artist per element — O(n_e) artists
is unusable at 1M elements).

matplotlib is imported lazily so headless compute paths never pay for it.
All functions accept `ax=None` (draws into a fresh figure) and return the
artist for further styling; `show=False` supports test/CI use.
"""
from __future__ import annotations

from typing import Optional

import numpy as np

from .mesh.structured import Mesh
from .ops.elements import ElementType


def _plt():
    import matplotlib.pyplot as plt

    return plt


def _corner_polys(coords: np.ndarray, elems: np.ndarray, etype: ElementType):
    n_corners = 4 if etype.is_quad else 3
    return coords[elems[:, :n_corners]]


def draw_mesh(mesh: Mesh, ax=None, show: bool = True):
    """Wireframe mesh + nodes (reference `draw_mesh`)."""
    plt = _plt()
    from matplotlib.collections import PolyCollection

    if ax is None:
        _, ax = plt.subplots(subplot_kw={"aspect": "equal"})
    polys = _corner_polys(np.asarray(mesh.coords), np.asarray(mesh.elems), mesh.etype)
    pc = PolyCollection(polys, facecolors="white", edgecolors="tab:blue", linewidths=0.4)
    ax.add_collection(pc)
    ax.plot(mesh.coords[:, 0], mesh.coords[:, 1], ".", color="tab:blue", ms=1.5)
    ax.autoscale()
    ax.set_axis_off()
    if show:
        plt.show()
    return pc


def draw_quantity(
    mesh: Mesh,
    u: np.ndarray,
    q_node: np.ndarray,
    ax=None,
    show: bool = True,
    cmap: str = "viridis",
    deform_scale: float = 1.0,
    outline: Optional[str] = None,
):
    """Nodal scalar field on the (optionally deformed) mesh.

    Reference `draw_quantity` (T:1329-1351) hard-codes the tsx domain box
    and tunnel ellipse; pass `outline="tsx"` or `outline="square"` for the
    equivalent overlays.
    """
    plt = _plt()
    from matplotlib.collections import PolyCollection

    if ax is None:
        fig, ax = plt.subplots(subplot_kw={"aspect": "equal"})
    coords = np.asarray(mesh.coords) + deform_scale * np.asarray(u).reshape(-1, 2)
    elems = np.asarray(mesh.elems)
    n_c = 4 if mesh.etype.is_quad else 3
    polys = coords[elems[:, :n_c]]
    vals = np.asarray(q_node)[elems[:, :n_c]].mean(axis=1)
    pc = PolyCollection(polys, array=vals, cmap=cmap, edgecolors="none")
    ax.add_collection(pc)
    plt.colorbar(pc, ax=ax)
    if outline == "tsx":
        ax.plot([-50, 50, 50, -50, -50], [-50, -50, 50, 50, -50], "k-", lw=0.8)
        t = np.linspace(0, 2 * np.pi, 200)
        ax.plot(2.1875 * np.cos(t), 1.75 * np.sin(t), "k-", lw=0.8)
    elif outline == "square":
        lim = coords.max()
        ax.plot([0, lim, lim, 0, 0], [0, 0, lim, lim, 0], "k-", lw=0.8)
    ax.autoscale()
    ax.set_axis_off()
    if show:
        plt.show()
    return pc


def draw_displacement(mesh: Mesh, u: np.ndarray, ax=None, show: bool = True):
    """Deformed shape colored by displacement magnitude (E:990-1048)."""
    u = np.asarray(u).reshape(-1, 2)
    mag = np.sqrt((u**2).sum(axis=1))
    return draw_quantity(mesh, u, mag, ax=ax, show=show)


def plot_load_curve(
    zeta_hist, monitor_hist, n_steps: int, xscale: float = 17.0,
    xlabel: str = "day", ylabel: str = "displacement on the tunnel wall",
    ax=None, show: bool = True,
):
    """Load-factor history vs monitored quantity (T:1839-1842)."""
    plt = _plt()
    if ax is None:
        _, ax = plt.subplots()
    line = ax.plot(
        xscale * np.asarray(zeta_hist)[:n_steps], np.asarray(monitor_hist)[:n_steps]
    )
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if show:
        plt.show()
    return line


def save_figures(directory: str, prefix: str) -> list:
    """Write every open figure to `directory` as `<prefix>_<k>.png`, in the
    order they were made, and close them; returns the paths (the example scripts'
    `--figdir`, for runs without a display)."""
    import os

    plt = _plt()
    os.makedirs(directory, exist_ok=True)
    paths = []
    for k, num in enumerate(plt.get_fignums()):
        path = os.path.join(directory, f"{prefix}_{k}.png")
        plt.figure(num).savefig(path)
        paths.append(path)
    plt.close("all")
    return paths
