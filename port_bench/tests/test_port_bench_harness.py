"""Dry runs of the harness on tiny cells that live only in a temporary
directory: found by name, with no edit to the harness."""
import json
import subprocess
import sys
import time

import pytest
import torch

from port_bench import harness
from port_bench.tests.cells import REPO, make_root


def run(root, workload, traced, seed=2**31 + 977):
    lines = []
    out = harness.run_cell(root, workload, seed, 0.5, traced, torch.device("cpu"),
                           time.time(), lines.append)
    return out, lines


# the end-to-end metrics a CPU run reads: the tsx's device_s needs a card's trace
HOST_E2E = {"tsx": {"setup_s"}, "footing": {"solve_s", "setup_s"}}


@pytest.mark.parametrize("kind", ["tsx", "footing"])
def test_dry_run_is_correct(tmp_path, kind):
    root, workload = make_root(tmp_path, kind)
    out, lines = run(root, workload, traced=False)
    assert out["correct"], lines
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert set(out["metrics"]) == HOST_E2E[kind]
    assert all(m["value"] > 0 for m in out["metrics"].values())
    assert list(out)[-1] == "checks"
    assert all(c["value"] is not None and c["value"] <= c["limit"]
               for c in out["checks"].values())


def test_traced_dry_run_reports_the_host_side_metrics(tmp_path):
    root, workload = make_root(tmp_path, "tsx")
    out, lines = run(root, workload, traced=True)
    assert out["correct"], lines
    # the device metrics need a card's trace; the host's are read here
    assert {"build_s", "cg_iters.tsx", "cg_iter_ms.tsx", "solve_s.tsx"} <= set(out["metrics"])
    assert out["metrics"]["cg_iters.tsx"]["value"] > 0


def test_mix_states_the_material():
    from port_bench import traffic

    mix = json.loads((REPO / "port_bench" / "traffic" / "excavation.json").read_text())
    assert traffic.material(mix) == {"cohesion": 18.7, "friction_angle_deg": 49.0}
    with pytest.raises(ValueError):
        traffic.material(dict(mix, material=dict(mix["material"], young=1.0)))
    with pytest.raises(ValueError):
        traffic.material(dict(mix, material={"cohesion": 18.7}))


def test_without_a_card_the_command_fails_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    p = subprocess.run([sys.executable, "-m", "port_bench.run", "--workload",
                        "tsx_l5.excavation", "--seed", "1", "--seconds", "1", "--trace", "0"],
                       cwd=REPO, capture_output=True, text=True, timeout=300)
    assert p.returncode != 0 and p.stdout == ""


@pytest.mark.gpu
def test_traced_run_on_the_card_reads_the_device(tmp_path, card):
    root, workload = make_root(tmp_path, "tsx")
    # refine level 1 has no bf16 level (K5 packs levels of 500,000 rows or
    # more), so k5_roofline has nothing to read in this cell
    bench = json.loads((root / "BENCHMARK.json").read_text())
    next(m for m in bench["per_layer"] if m["name"] == "k5_roofline")["workloads"] = []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    lines = []
    out = harness.run_cell(root, workload, 2**31 + 31, 0.5, True, card, time.time(),
                           lines.append)
    assert out["correct"], lines
    m = out["metrics"]
    assert 0.0 < m["idle_share.tsx"]["value"] < 1.0
    assert m["kernels_per_cg_iter.tsx"]["value"] > 1.0
    assert 0.0 < m["k3_product_roofline"]["value"] <= 105.0
    assert 0.0 < out["device"]["busy_s"] < out["device"]["window_s"]


@pytest.mark.gpu
def test_untraced_run_on_the_card_reads_device_s(tmp_path, card):
    root, workload = make_root(tmp_path, "tsx")
    lines = []
    out = harness.run_cell(root, workload, 2**31 + 57, 0.5, False, card, time.time(),
                           lines.append)
    assert out["correct"], lines
    assert set(out["metrics"]) == {"device_s", "setup_s"}
    assert 0.0 < out["metrics"]["device_s"]["value"] < out["metrics"]["setup_s"]["value"]


def test_split_metrics_share_one_reader():
    assert harness.reader("idle_share.tsx") is harness.reader("idle_share")
    with pytest.raises(ModuleNotFoundError):
        harness.reader("no_such_metric.tsx")


def test_a_span_the_port_lacks_raises():
    from port_bench import trace

    spmv = "fem_elastoplasticity_tpu_torch.ops.spmv"
    with pytest.raises(trace.TraceError, match="no_such_kernel"):
        with trace.wrapped([(spmv, "no_such_kernel", lambda *a, **k: "tag")]):
            pass
    with pytest.raises(trace.TraceError, match="no module"):
        with trace.wrapped([(spmv + "_gone", "node_block_spmv_cuda", lambda *a, **k: "tag")]):
            pass


def test_traced_run_whose_spans_launch_nothing_fails(tmp_path, monkeypatch):
    """A trace in which no device work ran inside a metric's spans (a
    kernel moved out of the wrapped functions) ends the run with
    TraceError, not with the metric quietly left out."""
    from port_bench import trace

    def outside_every_span(call, n, device, spans=()):
        with trace.wrapped(spans):
            results = [call() for _ in range(n)]
        op = trace.DeviceOp("block_jacobi_sweep_kernel", 0, 1000, (("elsewhere.fn", "x"),))
        return results, trace.Trace(wall_s=1.0, requests=n, ops=[op], host_reads=1)

    root, workload = make_root(tmp_path, "tsx")
    monkeypatch.setattr(trace, "traced", outside_every_span)
    with pytest.raises(trace.TraceError, match="no device work was launched inside"):
        run(root, workload, traced=True)
    op = trace.DeviceOp("k", 0, 10, (("a.b", "t"),))
    t = trace.Trace(wall_s=1.0, requests=1, ops=[op], host_reads=0)
    assert t.launches_in({"a.b"}) == 1 and t.launches_in({"c.d"}) == 0
    assert t.in_span("t") == [(op, "t")]
