"""PyTorch port: the strip footing with Q1, P2 and Q2 elements.

The dense f64 footing at level 0 with the reference's apex plastic strain
(`bug_compatible_apex=True`) is held to the schedules and pressures that
the JAX package's tests captured from the unmodified reference
(`REFERENCE_BY_ETYPE`, copied with its citation into
`tests/fixtures/torch_port/footing_reference_by_etype.json`): the accepted
zeta schedule exactly, the pressures within 1e-11 of the largest.  No JAX
run is needed.  The df32 presets follow the f64 schedule, and the
assembled CG route reads the
JAX package's two residual layouts as one CSR: "slot" and "rslot" give the
same bits.  The level-1 assembled runs against the matrix-free ones are
for the card (`chip_smoke.py` phase 34).
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType

torch.set_num_threads(1)

# tests/test_footing.py:118-161, captured from the unmodified reference at
# level 0 (`Plasticity2D_DP/pythonFEM.py:901` takes any element type): the
# accepted zeta schedule and the footing pressure of every accepted step,
# copied into a fixture that `chip_smoke.py` phase 34 reads too
_REF = json.loads((pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
                   / "footing_reference_by_etype.json").read_text())
REFERENCE_BY_ETYPE = {et: (_REF[et]["zeta"], _REF[et]["pressure"]) for et in ("Q1", "P2", "Q2")}


def _config(et: str, **kw) -> FootingConfig:
    return FootingConfig(etype=ElementType[et], level=0, bug_compatible_apex=True, **kw)


_F64 = {}


def _f64(et: str):
    if et not in _F64:
        _F64[et] = footing.solve(_config(et), device="cpu")
    return _F64[et]


@pytest.mark.parametrize("et", ["Q1", "P2", "Q2"])
def test_schedule_and_pressures_match_reference(et):
    ref_z, ref_p = REFERENCE_BY_ETYPE[et]
    r = _f64(et)
    n = r.n_steps
    assert n == len(ref_z)
    np.testing.assert_array_equal(r.zeta_hist[1: n + 1], ref_z)
    assert np.abs(r.pressure_hist[1: n + 1] - ref_p).max() / max(ref_p) < 1e-11


@pytest.mark.parametrize("et", ["Q1", "P2", "Q2"])
def test_df32_dense_follows_the_f64_schedule(et):
    """`FootingConfig.fast()` at level 0: the f64 run's schedule, u within
    1e-9 and the pressures within 1e-5 (the rules of the P1 preset's own test)."""
    r64 = _f64(et)
    r = footing.solve(dataclasses.replace(FootingConfig.fast(), etype=ElementType[et], level=0,
                                          bug_compatible_apex=True), device="cpu")
    n = r64.n_steps
    assert r.n_steps == n
    np.testing.assert_allclose(r.zeta_hist[1: n + 1], r64.zeta_hist[1: n + 1], rtol=1e-12)
    assert np.abs(r.u - r64.u).max() / np.abs(r64.u).max() < 1e-9
    p, p64 = r.pressure_hist[1: n + 1], r64.pressure_hist[1: n + 1]
    assert np.abs(p - p64).max() / np.abs(p64).max() < 1e-5


@pytest.mark.parametrize("et", ["Q1", "Q2"])
def test_assembled_cg_slot_and_rslot_are_one_route(et):
    """The assembled CG route on quads: its node blocks (a Q2 node couples
    up to 25 nodes) and the residual in CSR; "slot" and "rslot" name that
    one CSR route, bit for bit, and the result tracks the matrix-free CG
    (the JAX package's gates, `tests/test_footing.py:246-265`)."""
    kw = dict(etype=ElementType[et], level=0, zeta_max=0.001, solver="cg", cg_maxiter=4000)
    runs = {}
    for fmt in ("slot", "rslot"):
        pspmv.LAUNCHES.clear()
        runs[fmt] = footing.solve(FootingConfig.fast(assembled_cg=True, residual_fmt=fmt, **kw),
                                  device="cpu")
        assert pspmv.LAUNCHES["node_block_spmv_plain"] > 0
        assert pspmv.LAUNCHES["csr_spmv_f64_plain"] > 0
    assert np.array_equal(runs["slot"].u, runs["rslot"].u)
    mf = footing.solve(FootingConfig.fast(**kw), device="cpu")
    a = runs["slot"]
    assert abs(a.pressure_hist[a.n_steps] - mf.pressure_hist[mf.n_steps]) \
        < 5e-3 * abs(mf.pressure_hist[mf.n_steps])
    n = min(a.n_steps, mf.n_steps, 6)
    np.testing.assert_allclose(a.pressure_hist[1: n + 1], mf.pressure_hist[1: n + 1], rtol=1e-5)


def test_scan_structure_gives_the_while_run():
    """`cg_structure="scan"` on the footing's CG route: the same bits."""
    kw = dict(etype=ElementType.Q1, level=0, zeta_max=0.003, solver="cg", cg_maxiter=300)
    w = footing.solve(FootingConfig(**kw), device="cpu")
    s = footing.solve(FootingConfig(cg_structure="scan", **kw), device="cpu")
    assert (s.n_steps, s.n_newton_total, s.n_cg_total) == (w.n_steps, w.n_newton_total,
                                                             w.n_cg_total)
    assert np.array_equal(s.u, w.u)


def test_config_refusals():
    for kw, exc in [
        (dict(etype=ElementType.P4), NotImplementedError),
        (dict(etype=ElementType.Q2, solver="cg", tangent_mg=True, precision="df32",
              dtype="float32", level=2), NotImplementedError),
        (dict(solver="cg", residual_fmt="slot"), NotImplementedError),  # matrix-free
        (dict(solver="cg", residual_fmt="ell", assembled_cg=True, precision="df32",
              dtype="float32"), NotImplementedError),
    ]:
        with pytest.raises(exc):
            FootingConfig(**kw)
    assert FootingConfig.fast(etype=ElementType.P2, solver="cg", assembled_cg=True,
                              residual_fmt="rslot").residual_fmt == "rslot"
