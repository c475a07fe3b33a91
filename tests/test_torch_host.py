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
from fem_elastoplasticity_tpu.ops import elements as jel
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as ptsx
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.ops import assembly as pasm
from fem_elastoplasticity_tpu_torch.ops import elements as pel
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
        dict(solver="cg"),
        dict(support_pressure=1.0),
        dict(etype=pel.ElementType.P2),
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
    with pytest.raises(NotImplementedError):
        TsxTunnelConfig.fast_scale(2)
    with pytest.raises(NotImplementedError):
        TsxTunnelConfig.fast(dense_mode="mixed")
    with pytest.raises(NotImplementedError):
        FootingConfig.fast()
    with pytest.raises(NotImplementedError):
        FootingConfig.fast_scale(4)
    fast32 = TsxTunnelConfig.fast_f32()
    assert (fast32.dtype, fast32.precision, fast32.newton_tol, fast32.accept_tol) == (
        "float32", "native", 1e-6, 1e-5)


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
        dict(solver="cg"),
        dict(assembled_cg=True),
        dict(tangent_mg=True),
        dict(cg_deflate=16),
        dict(newton_damping=3),
        dict(residual_fmt="slot"),
        dict(precision="df32", dtype="float32"),
        dict(etype=pel.ElementType.P2),
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
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m.startswith('fem_elastoplasticity_tpu.') or m == 'fem_elastoplasticity_tpu']\n"
        "print(bad); sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
