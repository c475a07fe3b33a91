"""PyTorch port: the visualization layer (`viz.py`), headless (Agg).

The cases of the JAX package's `tests/test_viz.py` on the port's meshes,
and the collections the port draws held to the JAX module's on the same
tsx mesh and field: the same polygon vertices and colour array.
"""
import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from fem_elastoplasticity_tpu import viz as jviz  # noqa: E402
from fem_elastoplasticity_tpu.models.tsx_tunnel import tsx_mesh as jtsx_mesh  # noqa: E402
from fem_elastoplasticity_tpu.ops.elements import ElementType as JElementType  # noqa: E402
from fem_elastoplasticity_tpu_torch import viz  # noqa: E402
from fem_elastoplasticity_tpu_torch.mesh.structured import square_with_hole_mesh  # noqa: E402
from fem_elastoplasticity_tpu_torch.models.tsx_tunnel import tsx_mesh  # noqa: E402
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType  # noqa: E402


@pytest.fixture(scope="module")
def mesh():
    return tsx_mesh(ElementType.P1)


@pytest.fixture(autouse=True)
def _close_figures():
    yield
    plt.close("all")


def test_draw_mesh(mesh):
    pc = viz.draw_mesh(mesh, show=False)
    assert len(pc.get_paths()) == mesh.n_elems


def test_draw_quantity_with_tsx_outline(mesh):
    q = np.linalg.norm(mesh.coords, axis=1)
    pc = viz.draw_quantity(mesh, np.zeros((mesh.n_nodes, 2)), q, show=False, outline="tsx")
    assert pc.get_array().shape == (mesh.n_elems,)


def test_draw_displacement_quad():
    m = square_with_hole_mesh(1, ElementType.Q2, 10.0, 5.0)
    u = 1e-3 * np.random.default_rng(0).normal(size=(m.n_nodes, 2))
    pc = viz.draw_displacement(m, u, show=False)
    assert len(pc.get_paths()) == m.n_elems


def test_load_curve():
    line = viz.plot_load_curve(
        np.linspace(0, 1, 17), -1e-3 * np.linspace(0, 2, 17), 17, show=False
    )
    assert line


@pytest.mark.parametrize("outline", ["tsx", "square"])
def test_collections_equal_the_jax_modules(mesh, outline):
    jmesh = jtsx_mesh(JElementType.P1)
    np.testing.assert_array_equal(mesh.coords, jmesh.coords)
    rng = np.random.default_rng(38)
    u = 1e-3 * rng.normal(size=(mesh.n_nodes, 2))
    q = np.linalg.norm(u, axis=1)
    ours = viz.draw_quantity(mesh, 300 * u, q, show=False, outline=outline)
    theirs = jviz.draw_quantity(jmesh, 300 * u, q, show=False, outline=outline)
    assert len(ours.get_paths()) == len(theirs.get_paths()) == mesh.n_elems
    for a, b in zip(ours.get_paths(), theirs.get_paths()):
        np.testing.assert_array_equal(a.vertices, b.vertices)
    np.testing.assert_array_equal(ours.get_array(), theirs.get_array())
    # the outline lines too
    assert len(ours.axes.lines) == len(theirs.axes.lines) == (2 if outline == "tsx" else 1)
    for a, b in zip(ours.axes.lines, theirs.axes.lines):
        np.testing.assert_array_equal(a.get_xydata(), b.get_xydata())
    wire, jwire = viz.draw_mesh(mesh, show=False), jviz.draw_mesh(jmesh, show=False)
    for a, b in zip(wire.get_paths(), jwire.get_paths()):
        np.testing.assert_array_equal(a.vertices, b.vertices)


def test_save_figures(tmp_path, mesh):
    viz.draw_mesh(mesh, show=False)
    viz.plot_load_curve(np.linspace(0, 1, 17), np.linspace(0, 2, 17), 17, show=False)
    paths = viz.save_figures(str(tmp_path / "figs"), "tsx")
    assert [p.rsplit("/", 1)[-1] for p in paths] == ["tsx_0.png", "tsx_1.png"]
    assert all((tmp_path / "figs" / name).stat().st_size > 0 for name in ("tsx_0.png",
                                                                         "tsx_1.png"))
    assert plt.get_fignums() == []
