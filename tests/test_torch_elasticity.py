"""PyTorch port: the square-with-hole elasticity problem (CPU).

The port's mesh generator, load vectors and solves against the JAX package
on the same inputs, and its energies against the reference's anchors
(BASELINE.md; Q1 from tests/test_elasticity.py).  The meshes are integer
and host arithmetic, so they must be identical; the load vectors differ in
summation order only (1e-14); the dense energies hit the anchors to 1e-10
and the matrix-free CG solve the dense one to 1e-11.  No kernel lies on
this path.
"""
import dataclasses
import pathlib

import numpy as np
import pytest
import torch

import fem_elastoplasticity_tpu.ops.assembly as jasm
from fem_elastoplasticity_tpu.mesh import boundary as jboundary
from fem_elastoplasticity_tpu.mesh import structured as jstructured
from fem_elastoplasticity_tpu.models.config import ElasticityConfig as JaxElasticityConfig
from fem_elastoplasticity_tpu.ops import elements as jel
from fem_elastoplasticity_tpu_torch.mesh import boundary, io, structured
from fem_elastoplasticity_tpu_torch.models import elasticity
from fem_elastoplasticity_tpu_torch.models.config import ElasticityConfig
from fem_elastoplasticity_tpu_torch.ops import assembly as asm
from fem_elastoplasticity_tpu_torch.ops.elements import (ElementType, surface_element,
                                                         volume_element)

jnp = pytest.importorskip("jax.numpy")
torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
FAMILIES = ("P1", "P2", "Q1", "Q2")
ANCHORS = {  # (element, level): stored energy
    ("P1", 1): 2786.3472189077,
    ("P1", 2): 2717.5492666201,
    ("Q1", 1): 2728.399597423172,
    ("Q2", 1): 2642.1861301492,
}


@pytest.mark.parametrize("etype,level", list(ANCHORS), ids=lambda v: str(v))
def test_dense_energy_hits_the_anchor(etype, level):
    r = elasticity.solve(ElasticityConfig(etype=ElementType[etype], level=level), device="cpu")
    want = ANCHORS[(etype, level)]
    assert abs(r.energy - want) / want < 1e-10
    assert r.u.shape == (r.mesh.n_nodes, 2) and np.isfinite(r.u).all()


@pytest.mark.parametrize("etype", FAMILIES)
def test_hole_mesh_is_the_jax_packages(etype):
    ours = structured.square_with_hole_mesh(1, ElementType[etype], 10.0, 5.0)
    theirs = jstructured.square_with_hole_mesh(1, jel.ElementType[etype], 10.0, 5.0)
    for f in ("coords", "elems", "surface", "neumann"):
        a, b = getattr(ours, f), getattr(theirs, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


@pytest.mark.parametrize("etype", FAMILIES)
def test_square_mesh_keeps_its_numbering(etype):
    ours = structured.square_mesh(2, ElementType[etype], 10.0)
    theirs = jstructured.square_mesh(2, jel.ElementType[etype], 10.0)
    for f in ("coords", "elems", "surface", "neumann"):
        assert np.array_equal(getattr(ours, f), getattr(theirs, f)), f


@pytest.mark.parametrize("etype", FAMILIES)
def test_load_vectors_equal_jax(etype):
    cfg = ElasticityConfig(etype=ElementType[etype])
    mesh = elasticity.build_mesh(cfg)
    ref, surf = volume_element(cfg.etype), surface_element(cfg.etype)
    coords = torch.as_tensor(mesh.coords)
    geom = asm.compute_geometry(coords, mesh.elems, ref)
    f_v = asm.volume_force_vector(geom, ref, cfg.volume_force).numpy()
    f_t = asm.traction_force_vector(coords, mesh.neumann, surf, cfg.traction_force,
                                    mesh.n_nodes).numpy()

    jtype = jel.ElementType[etype]
    jref, jsurf = jel.volume_element(jtype), jel.surface_element(jtype)
    jc = jnp.asarray(mesh.coords)
    jgeom = jasm.compute_geometry(jc, jnp.asarray(mesh.elems), jel.tables(jref))
    jf_v = np.asarray(jasm.volume_force_vector(jgeom, jel.tables(jref),
                                               jnp.asarray(cfg.volume_force)))
    jf_t = np.asarray(jasm.traction_force_vector(jc, jnp.asarray(mesh.neumann),
                                                 jel.tables(jsurf),
                                                 jnp.asarray(cfg.traction_force),
                                                 mesh.n_nodes))
    for ours, theirs in ((f_v, jf_v), (f_t, jf_t)):
        assert ours.shape == theirs.shape
        assert np.abs(ours - theirs).max() <= 1e-14 * np.abs(theirs).max()


@pytest.mark.parametrize("etype", ("P1", "Q2"))
def test_cg_matches_dense(etype):
    dense = elasticity.solve(ElasticityConfig(etype=ElementType[etype]), device="cpu")
    cg = elasticity.solve(ElasticityConfig(etype=ElementType[etype], solver="cg"), device="cpu")
    assert abs(cg.energy - dense.energy) / abs(dense.energy) < 1e-11
    assert cg.cg_iters > 0
    assert np.abs(cg.u - dense.u).max() <= 1e-8 * np.abs(dense.u).max()


def test_cg_level3_energy_equals_jax():
    """The level-3 CG energy against the JAX package's (fixture
    elasticity_cg.npz, written by tools/make_port_fixtures.py)."""
    r = elasticity.solve(ElasticityConfig(level=3, solver="cg"), device="cpu")
    want = float(np.load(FIXTURES / "elasticity_cg.npz")["energy_l3"])
    assert abs(r.energy - want) / want < 1e-9


def test_config_is_the_jax_packages():
    ours, theirs = ElasticityConfig(), JaxElasticityConfig()
    for f in dataclasses.fields(ElasticityConfig):
        if f.name != "etype":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    with pytest.raises(NotImplementedError):
        ElasticityConfig(solver="ell")


@pytest.mark.parametrize("etype", ("P1", "P2"))
def test_boundary_edges_equal_jax(etype):
    mesh = structured.square_with_hole_mesh(1, ElementType[etype], 10.0, 5.0)
    ours = boundary.boundary_edges(mesh.elems, ElementType[etype])
    theirs = jboundary.boundary_edges(mesh.elems, jel.ElementType[etype])
    assert ours.dtype == theirs.dtype and np.array_equal(ours, theirs)
    # every boundary edge of the generator is found, each once
    assert {tuple(sorted(e[:2])) for e in ours} == {tuple(sorted(e[:2])) for e in mesh.surface}


def test_csv_mesh_round_trip(tmp_path):
    mesh = structured.square_with_hole_mesh(1, ElementType.P1, 10.0, 5.0)
    io.save_csv_mesh(mesh, tmp_path / "coord.csv", tmp_path / "elem.csv")
    back = io.load_csv_mesh(tmp_path / "coord.csv", tmp_path / "elem.csv")
    assert np.array_equal(back.coords, mesh.coords) and np.array_equal(back.elems, mesh.elems)
    assert back.elems.dtype == np.int32 and back.etype == ElementType.P1
