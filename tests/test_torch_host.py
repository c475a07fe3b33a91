"""PyTorch port: host geometry, configuration, state conversion and imports.

The port's NumPy copies of the mesh and element code must give arrays equal
to the JAX package's; the port must import without JAX.
"""
import dataclasses
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu.models import tsx_tunnel as jtsx
from fem_elastoplasticity_tpu.models.config import FootingConfig as JaxFootingConfig
from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig as JaxConfig
from fem_elastoplasticity_tpu.ops import assembly as jasm
from fem_elastoplasticity_tpu.models.materials import lame_moduli
from fem_elastoplasticity_tpu.ops import elements as jel
from fem_elastoplasticity_tpu.ops import spmv as jspmv
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as ptsx
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.ops import assembly as pasm
from fem_elastoplasticity_tpu_torch.ops import elements as pel
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.utils import convert

# tiny tensors: extra threads only contend with the other test workers
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"


@pytest.mark.parametrize("level", [0, 1])
def test_tsx_mesh_equals_jax(level):
    jm = jtsx.tsx_mesh(jel.ElementType.P1, level)
    pm = ptsx.tsx_mesh(pel.ElementType.P1, level)
    np.testing.assert_array_equal(pm.coords, jm.coords)
    np.testing.assert_array_equal(pm.elems, jm.elems)
    np.testing.assert_array_equal(pm.free, jm.free)
    np.testing.assert_array_equal(pm.dirichlet, jm.dirichlet)
    assert pm.elems.dtype == jm.elems.dtype


def test_tsx_counts_and_data_file():
    pm = ptsx.tsx_mesh()
    assert (pm.n_nodes, pm.n_elems, pm.n_free_dofs) == (476, 887, 908)
    ours = ROOT / "fem_elastoplasticity_tpu_torch" / "data" / "tsx_tunnel_mesh.npz"
    theirs = ROOT / "fem_elastoplasticity_tpu" / "data" / "tsx_tunnel_mesh.npz"
    assert ours.read_bytes() == theirs.read_bytes()


@pytest.mark.parametrize("etype", list(jel.ElementType), ids=lambda e: e.name)
def test_element_tables_equal_jax(etype):
    for a, b in zip(pel.tables(pel.volume_element(pel.ElementType[etype.name])),
                    jel.tables(jel.volume_element(etype))):
        np.testing.assert_array_equal(a, b)


def test_free_dof_map_and_initial_state_equal_jax():
    mesh = jtsx.tsx_mesh()
    jm, jn = jasm.free_dof_map(mesh.free)
    pm, pn = pasm.free_dof_map(mesh.free)
    assert pn == jn == 908
    np.testing.assert_array_equal(pm, jm)
    for a, b in zip(ptsx.initial_state(TsxTunnelConfig()), jtsx.initial_state(JaxConfig())):
        np.testing.assert_array_equal(a, b)


def test_config_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(TsxTunnelConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxConfig)}
    assert ours.keys() == theirs.keys()
    for k in ours:
        if k == "etype":
            assert ours[k].name == theirs[k].name
        else:
            assert ours[k] == theirs[k], k
    fast = TsxTunnelConfig.fast(assembled_cg=True)
    assert (fast.dtype, fast.precision) == ("float32", "df32")


@pytest.mark.parametrize(
    "kw",
    [
        # solver="cg" and P2/P4 are ported (tests/test_torch_high_order.py);
        # the matrix-free multigrid and the quadrilaterals are not
        dict(solver="mg", etype=pel.ElementType.P2),
        dict(mg_cycle="w"),  # read by solver="ell" only
        dict(etype=pel.ElementType.Q1),
        dict(dtype="bfloat16"),
        dict(assembled_cg=True),
        dict(cg_deflate=4),
        dict(residual_fmt="ell"),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_config_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError):
        TsxTunnelConfig(**kw)


def test_config_refuses_unported_presets():
    # the scale preset is ported: the JAX package's preset, field by field
    ours, theirs = TsxTunnelConfig.fast_scale(2), JaxConfig.fast_scale(2)
    for f in dataclasses.fields(TsxTunnelConfig):
        if f.name != "etype":
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert (ours.solver, ours.corr_mode, ours.cg_tol, ours.cg_maxiter, ours.cg_eta0,
            ours.predictor_ir_iters, ours.refine_levels) == ("ell", "scatter", 1e-5, 200, 1e-2, 3, 2)
    with pytest.raises(NotImplementedError):
        TsxTunnelConfig.fast(dense_mode="mixed")
    # the footing's df32 preset is ported too: the JAX package's, field by field
    foot, jfoot = FootingConfig.fast(), JaxFootingConfig.fast()
    for f in dataclasses.fields(FootingConfig):
        if f.name != "etype":
            assert getattr(foot, f.name) == getattr(jfoot, f.name), f.name
    assert (foot.dtype, foot.precision, foot.newton_tol) == ("float32", "df32", 5e-12)
    # and its tangent-multigrid scale preset, field by field, except for
    # the variants still to port
    for level in (2, 5):
        scale, jscale = FootingConfig.fast_scale(level), JaxFootingConfig.fast_scale(level)
        for f in dataclasses.fields(FootingConfig):
            if f.name != "etype":
                assert getattr(scale, f.name) == getattr(jscale, f.name), f.name
    with pytest.raises(NotImplementedError):
        FootingConfig.fast_scale(4, etype=pel.ElementType.P2)
    fast32 = TsxTunnelConfig.fast_f32()
    assert (fast32.dtype, fast32.precision, fast32.newton_tol, fast32.accept_tol) == (
        "float32", "native", 1e-6, 1e-5)


@pytest.mark.parametrize(
    "kw",
    [
        dict(mg_cycle="f"),
        dict(cg_deflate=4, precision="native"),
        dict(spmv_fmt="rslot"),
        dict(solver="mg"),
        dict(etype=pel.ElementType.Q2),
        dict(precision="native"),
        dict(cg_structure="unrolled"),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_scale_preset_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError):
        TsxTunnelConfig.fast_scale(1, **kw)


def test_scale_preset_needs_a_refined_mesh_and_dense_refuses_its_fields():
    with pytest.raises(NotImplementedError):
        TsxTunnelConfig.fast_scale(0)
    for kw in (dict(cg_tol=1e-5), dict(cg_eta0=1e-2), dict(corr_mode="scatter"), dict(mg_nu=3)):
        with pytest.raises(NotImplementedError):
            TsxTunnelConfig.fast(**kw)


@pytest.fixture(scope="module")
def l1_rcm():
    """The once-refined tsx mesh on its RCM ordering, from the JAX package's
    host setup functions, with its BC-masked elastic CSR."""
    mesh = jtsx.tsx_mesh(jel.ElementType.P1, 1)
    order = jspmv.rcm_node_order(mesh.elems, mesh.n_nodes)
    c2, e2, noo = jspmv.permute_mesh(mesh.coords, mesh.elems, order)
    free2 = np.asarray(mesh.free)[order]
    shear, bulk = lame_moduli(60000.0, 0.2)
    arrays, meta, K = jspmv.build_ell_elastic(
        c2, e2, jel.volume_element(jel.ElementType.P1), shear, bulk, free=free2, fmt="slot")
    return dict(mesh=mesh, order=order, coords=c2, elems=e2, new_of_old=noo, free=free2,
                shear=shear, bulk=bulk, K=K, arrays=arrays, meta=meta)


def test_host_setup_functions_equal_jax(l1_rcm):
    m = l1_rcm
    mesh = m["mesh"]
    np.testing.assert_array_equal(pspmv.rcm_node_order(mesh.elems, mesh.n_nodes), m["order"])
    c2, e2, noo = pspmv.permute_mesh(mesh.coords, mesh.elems, m["order"])
    np.testing.assert_array_equal(c2, m["coords"])
    np.testing.assert_array_equal(e2, m["elems"])
    np.testing.assert_array_equal(noo, m["new_of_old"])
    dd, oo = 4.0 * m["shear"] / 3.0 + m["bulk"], -2.0 * m["shear"] / 3.0 + m["bulk"]
    d33 = np.array([[dd, oo, 0.0], [oo, dd, 0.0], [0.0, 0.0, m["shear"]]])
    jke, jed = jspmv.host_element_stiffness(c2, e2, jel.volume_element(jel.ElementType.P1), d33)
    pke, ped = pspmv.host_element_stiffness(c2, e2, pel.volume_element(pel.ElementType.P1), d33)
    np.testing.assert_array_equal(pke, jke)
    np.testing.assert_array_equal(ped, jed)
    jK, pK = jspmv.assemble_csr(jke, jed, 2 * c2.shape[0]), pspmv.assemble_csr(pke, ped, 2 * c2.shape[0])
    jKb, pKb = jspmv.apply_bc_csr(jK, m["free"].reshape(-1)), pspmv.apply_bc_csr(pK, m["free"].reshape(-1))
    for a, b in ((pK, jK), (pKb, jKb), (pKb, m["K"])):
        np.testing.assert_array_equal(a.indptr, b.indptr)
        np.testing.assert_array_equal(a.indices, b.indices)
        np.testing.assert_array_equal(a.data, b.data)
    K = pspmv.build_elastic_csr(c2, e2, pel.volume_element(pel.ElementType.P1),
                                m["shear"], m["bulk"], free=m["free"])
    assert K.has_sorted_indices and (K != m["K"]).nnz == 0 and K.nnz == m["K"].nnz
    np.testing.assert_array_equal(
        pspmv.diag_blocks_csr(K, c2.shape[0]), jspmv.diag_blocks_csr(m["K"], c2.shape[0]))
    rng = np.random.default_rng(0)
    rows, cols = rng.integers(0, K.shape[0], 500), rng.integers(0, K.shape[0], 500)
    rows[:100], cols[:100] = K.nonzero()[0][:100], K.nonzero()[1][:100]
    np.testing.assert_array_equal(pspmv.csr_lookup(K, rows, cols), jspmv.csr_lookup(m["K"], rows, cols))


def test_element_corr_dest_scatters_the_same_matrix_as_jax(l1_rcm):
    """Seeded element blocks scattered through the port's table into the CSR
    values, and through the JAX package's table into its slot values (read
    back through `slot_csr_positions`), give the same matrix."""
    m = l1_rcm
    K, elems, free = m["K"], m["elems"], m["free"]
    pdest = pspmv.element_corr_dest(K, elems, free)
    jdest = jspmv.element_corr_dest(K, m["meta"], elems, free)
    assert pdest.shape == jdest.shape == (elems.shape[0], 6, 6) and pdest.dtype == np.int32
    np.testing.assert_array_equal(pdest < 0, jdest < 0)
    edofs = np.stack([2 * elems, 2 * elems + 1], axis=-1).reshape(elems.shape[0], -1)
    fixed = ~free.reshape(-1)[edofs]
    np.testing.assert_array_equal(pdest < 0, fixed[:, :, None] | fixed[:, None, :])
    blocks = np.random.default_rng(1).standard_normal(pdest.shape)
    ok = pdest >= 0
    # the port: straight into a copy of the CSR values
    pvals = K.data.copy()
    np.add.at(pvals, pdest[ok], blocks[ok])
    # the JAX package: into the slot value stream, then back through the
    # entry -> cell map
    svals = np.asarray(m["arrays"]["vals"], np.float64).reshape(-1).copy()
    svals[jspmv.slot_csr_positions(K, m["meta"])] = K.data
    np.add.at(svals, jdest[ok], blocks[ok])
    jvals = svals[jspmv.slot_csr_positions(K, m["meta"])]
    np.testing.assert_allclose(pvals, jvals, rtol=0, atol=1e-12 * np.abs(jvals).max())
    assert np.abs(pvals - K.data).max() > 1.0  # the blocks did land


def test_footing_config_defaults_match_jax():
    ours = {f.name: f.default for f in dataclasses.fields(FootingConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxFootingConfig)}
    assert list(ours) == list(theirs)
    for k in ours:
        if k == "etype":
            assert ours[k].name == theirs[k].name
        else:
            assert ours[k] == theirs[k], k
    ours_f32, theirs_f32 = FootingConfig.fast_f32(), JaxFootingConfig.fast_f32()
    for k in ours:
        if k != "etype":
            assert getattr(ours_f32, k) == getattr(theirs_f32, k), k


@pytest.mark.parametrize(
    "kw",
    [
        dict(solver="ell"),
        dict(assembled_cg=True),
        dict(tangent_mg=True),
        dict(cg_deflate=16),
        dict(newton_damping=3),
        dict(residual_fmt="slot"),
        dict(precision="df32", dtype="float32", dense_mode="mixed"),
        dict(etype=pel.ElementType.P4),
    ],
    ids=lambda kw: next(iter(kw)),
)
def test_footing_config_refuses_what_is_not_ported(kw):
    with pytest.raises(NotImplementedError):
        FootingConfig(**kw)


def test_carry_round_trip():
    raw = dict(np.load(FIXTURES / "tsx_df32_carry9.npz"))
    carry = convert.carry_from_jax(raw)
    assert carry["step"] == 9 and carry["u"].dtype == torch.float64
    back = convert.carry_to_jax(carry)
    assert back.keys() == raw.keys()
    for k in raw:
        if k.endswith("__lo"):
            continue
        if k.endswith("__hi"):
            # a DF pair may hold more bits than f64; it round-trips as f64
            base = k[: -len("__hi")]
            got = convert.df_to_f64(back[k], back[base + "__lo"])
            np.testing.assert_array_equal(got, convert.df_to_f64(raw[k], raw[base + "__lo"]))
        else:
            np.testing.assert_array_equal(back[k], raw[k], err_msg=k)


def test_port_imports_without_jax():
    code = (
        "import sys, fem_elastoplasticity_tpu_torch\n"
        "import fem_elastoplasticity_tpu_torch.models.tsx_tunnel\n"
        "import fem_elastoplasticity_tpu_torch.models.footing\n"
        "import fem_elastoplasticity_tpu_torch.ops.return_map\n"
        "import fem_elastoplasticity_tpu_torch.utils.convert\n"
        "import fem_elastoplasticity_tpu_torch.utils.timing\n"
        "import fem_elastoplasticity_tpu_torch.utils.metrics\n"
        "import fem_elastoplasticity_tpu_torch.utils.checkpoint\n"
        "import fem_elastoplasticity_tpu_torch.viz\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('fem_elastoplasticity_tpu.') or m == 'fem_elastoplasticity_tpu']\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
