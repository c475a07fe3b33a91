"""PyTorch port: the side layers' utilities against the JAX package's.

`utils/checkpoint.py` (files cross between the packages; a split run
resumed from a file equals the uninterrupted one bit for bit, the
counterpart of `tests/test_utils.py`), `utils/metrics.py` (records equal
to the JAX functions' on the same arrays) and `utils/timing.py` (host
timers on the CPU; the card's measurements raise without a card).
"""
import functools
import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from fem_elastoplasticity_tpu.utils import checkpoint as jckpt
from fem_elastoplasticity_tpu.utils import metrics as jmetrics
from fem_elastoplasticity_tpu.utils import timing as jtiming
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes
from fem_elastoplasticity_tpu_torch.solve.newton import build_load_stepper, carry_of
from fem_elastoplasticity_tpu_torch.utils import checkpoint as ckpt
from fem_elastoplasticity_tpu_torch.utils import metrics, timing

torch.set_num_threads(1)  # small solves: threads only contend

CPU = torch.device("cpu")
ANCHOR_U40 = -1.9794499636012143e-03


def _checkpoint(deflated: bool = False) -> ckpt.SolverCheckpoint:
    rng = np.random.default_rng(16)
    return ckpt.SolverCheckpoint(
        u=rng.standard_normal(10), u_old=rng.standard_normal(10), u_it=rng.standard_normal(10),
        ep=rng.standard_normal((4, 8)), zeta_old=0.5 + 2.0**-50, d_zeta=1 / 17,
        d_zeta_old=1 / 17, step=3, aux=1.5, zeta_hist=np.arange(5.0) / 17,
        monitor_hist=rng.standard_normal(5), nits_total=7, ncg_total=11,
        defl_w=rng.standard_normal((10, 4)).astype(np.float32) if deflated else None,
        defl_ring=2 if deflated else 0,
    )


def _assert_same(a, b, fields=ckpt.JAX_FIELDS):
    for name in fields:
        x, y = getattr(a, name), getattr(b, name)
        if isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y, err_msg=name)
            assert x.dtype == np.asarray(y).dtype, name
        else:
            assert x == y and type(x) is type(y), (name, x, y)


# ---------------------------------------------------------------------------
# checkpoint
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("deflated", [False, True], ids=["plain", "deflated"])
def test_checkpoint_roundtrip(tmp_path, deflated):
    c = _checkpoint(deflated)
    path = tmp_path / "ck.npz"
    ckpt.save(str(path), c)
    c2 = ckpt.load(str(path))
    _assert_same(c, c2, ckpt.SolverCheckpoint._fields)
    with np.load(path) as raw:
        extra = {"defl_w", "defl_ring"} if deflated else set()
        assert set(raw.files) == set(ckpt.JAX_FIELDS) | extra


def test_checkpoint_files_cross_between_packages(tmp_path):
    assert ckpt.SolverCheckpoint._fields[:13] == jckpt.SolverCheckpoint._fields == ckpt.JAX_FIELDS
    ours = _checkpoint(deflated=True)
    ckpt.save(str(tmp_path / "port.npz"), ours)
    # the JAX loader reads the 13 fields and skips the deflation keys
    _assert_same(ours, jckpt.load(str(tmp_path / "port.npz")))
    theirs = jckpt.SolverCheckpoint(*_checkpoint()[:13])
    jckpt.save(str(tmp_path / "jax.npz"), theirs)
    back = ckpt.load(str(tmp_path / "jax.npz"))
    _assert_same(theirs, back)
    assert back.defl_w is None and back.defl_ring == 0


def test_carry_roundtrips_exactly():
    c = _checkpoint(deflated=True)
    carry = ckpt.to_carry(c, CPU)
    assert carry["u"].dtype == torch.float64 and carry["defl_w"].dtype == torch.float32
    _assert_same(c, ckpt.from_carry(carry), ckpt.SolverCheckpoint._fields)
    plain = ckpt.to_carry(_checkpoint(), CPU)
    assert "defl_w" not in plain and "defl_ring" not in plain


def _native_stepper(zeta_max: float):
    """`solve(TsxTunnelConfig())`'s load stepper with zeta_max replaced,
    and its start (the dense elastic predictor), as the JAX test builds
    its own."""
    cfg = TsxTunnelConfig()
    p = tsx._problem(cfg, CPU)
    shear, bulk, eta, c = p.consts
    D = elastic_tangent_lanes(shear, bulk, p.geom.n_int, torch.float64, CPU)
    u_elast, _ = tsx._dense_predictor(p, -tsx._initial_force(p), D)
    stepper = build_load_stepper(
        p.geom, p.free_idx, p.plan, shear, bulk, eta, c,
        p.settings._replace(zeta_max=zeta_max), e0_dir=p.e0,
        monitor=tsx._monitor(cfg.monitor_node), dense_mode=cfg.dense_mode,
    )
    return lambda resume=None: stepper(cfg.d_zeta * u_elast, 0.0, cfg.d_zeta, resume=resume)


def test_split_run_resumed_from_a_file_matches_full_run(tmp_path):
    """Solve to zeta 8/17, write the carry through `SolverCheckpoint`, read
    it back and resume to 1: the uninterrupted run's counts and u, exactly
    (`tests/test_utils.py` `TestResume`)."""
    full = tsx.solve(TsxTunnelConfig(), device=CPU)
    assert (full.n_steps, full.n_newton_total) == (17, 28)
    assert abs(full.u[40, 0] - ANCHOR_U40) / abs(ANCHOR_U40) < 1e-9

    part1 = _native_stepper(8 / 17)()
    assert 0 < part1.n_steps < 17
    path = tmp_path / "resume.npz"
    ckpt.save(str(path), ckpt.from_carry(carry_of(part1)))
    part2 = _native_stepper(1.0)(resume=ckpt.to_carry(ckpt.load(str(path)), CPU))

    assert int(part2.n_steps) == full.n_steps
    assert int(part2.n_newton_total) == full.n_newton_total
    np.testing.assert_allclose(part2.u.numpy(), full.u.reshape(-1), rtol=0, atol=0)
    np.testing.assert_allclose(part2.zeta_hist.numpy(), full.zeta_hist, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _z3():
    return tsx.solve(TsxTunnelConfig(zeta_max=3 / 17), device=CPU)


def _view(r):
    """The duck type the JAX tests build (`tests/test_utils.py`)."""
    return SimpleNamespace(zeta_hist=r.zeta_hist, monitor_hist=r.displ_hist,
                           n_steps=r.n_steps, n_newton_total=r.n_newton_total,
                           n_plastic=r.n_plastic)


def test_metrics_equal_the_jax_functions():
    r = _z3()
    recs = metrics.step_records(_view(r), "u40")
    assert len(recs) == 3
    assert recs == jmetrics.step_records(_view(r), "u40")
    # a TsxResult goes in as it is: its displ_hist is the monitor
    assert metrics.step_records(r, "u40") == recs
    s = metrics.summarize(_view(r), "u40")
    assert s == jmetrics.summarize(_view(r), "u40") == metrics.summarize(r, "u40")
    assert s["n_steps"] == 3


def test_log_run(caplog):
    r = _z3()
    with caplog.at_level("INFO", logger="fem_elastoplasticity_tpu_torch"):
        metrics.log_run(r, monitor_name="u40")
    msgs = [rec.getMessage() for rec in caplog.records
            if rec.name == "fem_elastoplasticity_tpu_torch"]
    assert any("run summary" in m and '"n_steps": 3' in m for m in msgs)
    assert sum("step:" in m for m in msgs) == 3


def test_jsonl(tmp_path):
    p = tmp_path / "m.jsonl"
    recs = metrics.step_records(_z3(), "u40")
    metrics.write_jsonl(str(p), recs)
    assert [json.loads(line) for line in p.read_text().splitlines()] == recs


# ---------------------------------------------------------------------------
# timing
# ---------------------------------------------------------------------------
def test_timer_laps_and_syncs():
    t = timing.Timer()
    x = torch.ones(4)
    with t.lap("x"):
        pass
    with t.lap("x", sync=lambda: (x, {"y": [x * 2]})):
        pass
    with t.lap("y") as box:
        box["sync"] = x + 1
    assert len(t.laps["x"]) == 2 and t.median("x") >= 0
    assert set(t.summary()) == {"x", "y"}
    assert timing._cuda_devices((x, {"a": [x]}), set()) == set()


def test_time_call_and_gdof():
    calls = []
    wall = timing.time_call(lambda v: calls.append(v) or torch.ones(3) * v, 2.0, reps=3,
                            warmup=2)
    assert len(calls) == 5 and wall >= 0
    assert timing.gdof_per_s(2_000_000_000, 2.0) == jtiming.gdof_per_s(2_000_000_000, 2.0) == 1.0


def test_trace(tmp_path):
    with timing.trace(None) as prof:
        assert prof is None
    with timing.trace(str(tmp_path / "tr")) as prof:
        torch.ones(8).sum()
    files = list((tmp_path / "tr").glob("trace.*.json"))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert "traceEvents" in json.loads(files[0].read_text())


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal on a card-less host")
@pytest.mark.parametrize("fn", [timing.cuda_ms, timing.profiled_kernels, timing.idle_share],
                         ids=["cuda_ms", "profiled_kernels", "idle_share"])
def test_device_measurements_raise_without_a_card(fn):
    with pytest.raises(RuntimeError, match="no CUDA card"):
        fn(lambda: torch.ones(2))
