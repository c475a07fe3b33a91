"""PyTorch port: the command-line examples `examples/*_torch.py`, run
in-process on the CPU (`--cpu`) through their `main(argv)`.

Each prints its JAX counterpart's lines with the tier-1 anchors: the
elasticity energy, the tsx's 17 steps / 28 Newton iterations and u40,
the footing's 16 steps; `--draw --figdir` writes non-empty figures
(Agg).  `--devices N` routes to the port's sharded solves (checked with
stand-ins, no ranks spawned); without `--cpu` and with no card the
scripts raise.
"""
import importlib.util
import pathlib
import re
from types import SimpleNamespace

import matplotlib

matplotlib.use("Agg")

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from fem_elastoplasticity_tpu.utils import metrics as jmetrics  # noqa: E402
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx  # noqa: E402
from fem_elastoplasticity_tpu_torch.utils import metrics  # noqa: E402

torch.set_num_threads(1)  # small solves: threads only contend

EXAMPLES = pathlib.Path(__file__).resolve().parents[1] / "examples"
SCRIPTS = ("elasticity2d_torch", "plasticity_dp_torch", "tsx_tunnel_torch")


def script(name: str):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def figures(directory: pathlib.Path, prefix: str, n: int) -> None:
    paths = sorted(directory.glob(f"{prefix}_*.png"))
    assert [p.name for p in paths] == [f"{prefix}_{k}.png" for k in range(n)]
    assert all(p.stat().st_size > 0 for p in paths)


def test_elasticity_example(capsys, tmp_path):
    script("elasticity2d_torch").main(["--etype", "P1", "--level", "1", "--cpu", "--draw",
                                       "--figdir", str(tmp_path)])
    out = capsys.readouterr().out
    energy = float(re.search(r"^Stored energy: (\S+)$", out, re.M).group(1))
    assert abs(energy - 2786.3472189077) / 2786.3472189077 < 1e-10
    figures(tmp_path, "elasticity2d", 2)


def test_tsx_example(capsys, tmp_path):
    script("tsx_tunnel_torch").main(["--cpu", "--draw", "--figdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "accepted steps: 17\nNewton iterations: 28\n" in out
    u40 = float(re.search(r"^tunnel-wall displacement u_x\(node 40\): (\S+)$", out,
                          re.M).group(1))
    assert abs(u40 - -1.9794499636012143e-03) / 1.9794499636012143e-03 < 1e-9
    figures(tmp_path, "tsx_tunnel", 3)


def test_footing_example(capsys, tmp_path):
    res = script("plasticity_dp_torch").main(["--cpu", "--draw", "--figdir", str(tmp_path)])
    out = capsys.readouterr().out
    assert out.startswith("accepted steps: 16\n")
    assert "Maximal load factor was achieved." in out
    assert "normalized footing pressure: [ 8.39724807 13.20017031" in out
    figures(tmp_path, "plasticity_dp", 1)
    # a FootingResult goes through the metrics as the JAX tests' duck type
    view = SimpleNamespace(zeta_hist=res.zeta_hist, monitor_hist=res.pressure_hist,
                           n_steps=res.n_steps, n_newton_total=res.n_newton_total,
                           n_plastic=res.n_plastic)
    assert metrics.step_records(res, "p") == jmetrics.step_records(view, "p")
    assert metrics.summarize(res, "p") == jmetrics.summarize(view, "p")


@pytest.mark.parametrize("fast", [False, True], ids=["f64", "df32"])
def test_tsx_example_devices_route_to_the_sharded_solves(capsys, monkeypatch, fast):
    calls = []
    u = np.zeros((476, 2))
    stub = SimpleNamespace(n_steps=2, n_newton_total=2, n_plastic=0, u=u)

    def fake(name):
        def solve(cfg, n_devices, device=None):
            calls.append((name, cfg, n_devices, device))
            return stub
        return solve

    monkeypatch.setattr(tsx, "solve_sharded", fake("solve_sharded"))
    monkeypatch.setattr(tsx, "solve_sharded_df32", fake("solve_sharded_df32"))
    argv = ["--cpu", "--devices", "2"] + (["--fast"] if fast else [])
    script("tsx_tunnel_torch").main(argv)
    assert "accepted steps: 2" in capsys.readouterr().out
    [(name, cfg, n, device)] = calls
    assert (n, device) == (2, "cpu")
    if fast:
        assert name == "solve_sharded_df32"
        assert (cfg.precision, cfg.solver) == ("df32", "cg")
    else:
        assert name == "solve_sharded"
        assert (cfg.precision, cfg.solver) == ("native", "dense")


@pytest.mark.skipif(torch.cuda.is_available(), reason="holds the refusal on a card-less host")
@pytest.mark.parametrize("name", SCRIPTS)
def test_examples_need_the_card_without_cpu(name):
    with pytest.raises(RuntimeError, match="no CUDA card is visible"):
        script(name).main([])
