"""The reference against the port at sizes the CPU holds, and the control:
the port's answers pass the cells' limits, the same answers rounded to
float32 fail them."""
import json

import numpy as np
import pytest

from port_bench.reference import compare, footing as ref_footing, tsx as ref_tsx
from port_bench.tests.cells import PB, bank_footing


def limits(workload):
    return json.loads((PB / "checks" / f"{workload}.json").read_text())["limits"]


def passes(numbers, lim):
    return all(numbers[k] <= v for k, v in lim.items())


@pytest.fixture(scope="module")
def tsx_l1():
    """The tsx cell's entry at refine level 1 on the CPU: the reference
    problem, the port's layout on it, one answer, the entry's split run."""
    import torch

    from port_bench import traffic
    from port_bench.entries import tsx_scale

    conf = json.loads((PB / "configs" / "tsx_l5.json").read_text())
    conf.update(refine_levels=1)
    material = traffic.material(json.loads((PB / "traffic" / "excavation.json").read_text()))
    cpu = torch.device("cpu")
    solver = tsx_scale.build(conf, material, None, cpu)
    answer = solver.answer(solver.request())
    split = tsx_scale.split(conf, material, None, cpu, answer)
    problem = ref_tsx.Problem(conf, material)
    return problem, compare.Mapped(problem, *solver.layout), answer, split


def tsx_numbers(tsx_l1, answer):
    problem, mapped, _, split = tsx_l1
    out = compare.numbers(problem, mapped, answer, split["before"]["ep"])
    out["resume_gap"] = compare.resume_gap(split["resumed"], answer)
    return out


def test_tsx_port_passes_and_control_fails(tsx_l1):
    problem, mapped, answer, split = tsx_l1
    lim = limits("tsx_l5.excavation")
    assert passes(tsx_numbers(tsx_l1, answer), lim)
    # the state a trip short of the end, judged by itself
    before = compare.numbers(problem, mapped, split["before"], final=False)
    assert "schedule_faults" not in before and "return_map_gap" not in before
    assert all(before[k] <= lim[k] for k in before)
    assert split["before"]["n_steps"] == answer["n_steps"] - 1
    low = tsx_numbers(tsx_l1, compare.control(answer))
    assert not passes(low, lim)
    assert low["eq_residual"] > lim["eq_residual"]
    assert low["return_map_gap"] > lim["return_map_gap"]


def test_tsx_faults_fail(tsx_l1):
    _, _, answer, _ = tsx_l1
    lim = limits("tsx_l5.excavation")
    unchanged = dict(answer, u=np.zeros_like(answer["u"]), ep=np.zeros_like(answer["ep"]))
    assert not passes(tsx_numbers(tsx_l1, unchanged), lim)
    altered = dict(answer, u=answer["u"].copy())
    altered["u"][np.argmax(np.abs(answer["u"][:, 0])), 0] *= 1.0 + 1e-6
    assert not passes(tsx_numbers(tsx_l1, altered), lim)
    short = dict(answer, zeta_hist=answer["zeta_hist"][:-1], n_steps=answer["n_steps"] - 1,
                 zeta=float(answer["zeta_hist"][-2]))
    assert tsx_numbers(tsx_l1, short)["schedule_faults"] > 0


def test_reference_mesh_is_the_ports(tsx_l1):
    from fem_elastoplasticity_tpu_torch.models.tsx_tunnel import tsx_mesh

    problem = tsx_l1[0]
    mesh = tsx_mesh(refine_levels=1)
    mapped = compare.Mapped(problem, np.asarray(mesh.coords), np.asarray(mesh.elems))
    # the reference numbers its own midpoints: the same nodes and constraints
    assert np.array_equal(problem.free[mapped.node], mesh.free)
    with pytest.raises(compare.LayoutError):
        bad = np.asarray(mesh.elems).copy()
        bad[0] = bad[1]
        compare.Mapped(problem, np.asarray(mesh.coords), bad)


def test_footing_trip_port_passes_and_control_fails(tmp_path):
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
    from fem_elastoplasticity_tpu_torch.utils.convert import load_checkpoint

    bank_footing(tmp_path / "ck.npz", level=2)
    run, mesh = footing.build_df32(FootingConfig.fast_scale(2, max_trips=1), device="cpu")
    r = run(resume=load_checkpoint(tmp_path / "ck.npz", device="cpu"))
    answer = {"u": r.u, "ep": r.ep, "zeta": r.carry["zeta_old"], "n_steps": r.n_steps,
              "zeta_hist": r.zeta_hist[1:r.n_steps + 1]}
    conf = dict(json.loads((PB / "configs" / "footing_l5.json").read_text()), level=2,
                checkpoint="ck.npz")
    problem = ref_footing.Problem(conf, {"cohesion": 450.0, "friction_angle_deg": 20.0},
                                  tmp_path)
    mapped = compare.Mapped(problem, np.asarray(mesh.coords), np.asarray(mesh.elems))
    lim = limits("footing_l5.plastic_trip")
    ep0 = problem.start()
    assert passes(compare.numbers(problem, mapped, answer, ep0), lim)
    assert not passes(compare.numbers(problem, mapped, compare.control(answer), ep0), lim)
    # the state handed back unchanged: the banked one, at the new load
    start = dict(answer, u=np.asarray(load_checkpoint(tmp_path / "ck.npz")["u"]).reshape(-1, 2),
                 ep=problem.ep_start)
    assert not passes(compare.numbers(problem, mapped, start, ep0), lim)
