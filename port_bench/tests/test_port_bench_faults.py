"""A run with the timed path broken underneath comes out not correct: the
port's solve, as the entry calls it, hands back its state unchanged, or an
answer altered where it is produced, or its return map stops inside the
yield surface.  (The cells have no batch to halve
and run on one card, with no exchange between cards to leave out.)"""
import time

import numpy as np
import pytest
import torch

from port_bench import harness
from port_bench.tests.cells import make_root


def broken(monkeypatch, module, fault):
    """Wrap the port's build_df32 so its run() passes through `fault`."""
    build = module.build_df32

    def build_broken(*a, **k):
        run, mesh = build(*a, **k)
        return (lambda *ra, **rk: fault(run(*ra, **rk), rk.get("resume"))), mesh

    monkeypatch.setattr(module, "build_df32", build_broken)


def tsx_unchanged(res, resume):
    return res._replace(u=torch.zeros_like(res.u), ep=torch.zeros_like(res.ep))


def tsx_altered(res, resume):
    u = res.u.clone()
    k = int(torch.argmax(u.abs()))
    u[k] *= 1.0 + 1e-6
    return res._replace(u=u)


def footing_unchanged(res, resume):
    return res._replace(u=resume["u"].numpy().reshape(-1, 2), ep=resume["ep"].numpy())


def footing_altered(res, resume):
    ep = res.ep.copy()
    k = np.unravel_index(np.argmax(np.abs(ep)), ep.shape)
    ep[k] *= 1.0 + 1e-6
    return res._replace(ep=ep)


def run_broken(root, workload):
    lines = []
    out = harness.run_cell(root, workload, 2**31 + 3, 0.5, False, torch.device("cpu"),
                           time.time(), lines.append)
    return out, lines


@pytest.mark.parametrize("kind,fault", [("tsx", tsx_unchanged), ("tsx", tsx_altered),
                                        ("footing", footing_unchanged),
                                        ("footing", footing_altered)])
def test_broken_timed_path_is_not_correct(tmp_path, monkeypatch, kind, fault):
    from fem_elastoplasticity_tpu_torch.models import footing, tsx_tunnel

    root, workload = make_root(tmp_path, kind)
    broken(monkeypatch, tsx_tunnel if kind == "tsx" else footing, fault)
    out, lines = run_broken(root, workload)
    assert out["correct"] is False, lines


def test_return_map_inside_the_surface_is_not_correct(tmp_path, monkeypatch):
    """The port's df32 return map projecting onto a yield surface 1% too
    small: its Newton solves still end in equilibrium, with every stress
    admissible, so only the return map's own comparison can catch it."""
    from fem_elastoplasticity_tpu_torch.solve import newton

    lanes = newton.dp_return_map_lanes

    def shrunk(e, ep, shear, bulk, eta, c, *a, **k):
        return lanes(e, ep, shear, bulk, eta, c * 0.99, *a, **k)

    root, workload = make_root(tmp_path, "tsx")
    monkeypatch.setattr(newton, "dp_return_map_lanes", shrunk)
    out, lines = run_broken(root, workload)
    checks = out["checks"]
    assert out["correct"] is False, lines
    assert checks["eq_residual"]["value"] <= checks["eq_residual"]["limit"]
    assert checks["yield_excess"]["value"] <= checks["yield_excess"]["limit"]
    assert checks["return_map_gap"]["value"] > checks["return_map_gap"]["limit"]
