"""BENCHMARK.json against the shape the benchmark's contract fixes, and
every name it gives against the files that the harness finds by it."""
import json
import re

from port_bench.tests.cells import PB, REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
B = json.loads((REPO / "BENCHMARK.json").read_text())


def test_keys_and_names():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert B["paths"] == ["port_bench"] and 1 <= B["run_seconds"] <= 51
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and NAME.match(c["name"])
        assert c["file"].startswith("port_bench/") and len(c["source"]) <= 200
        assert json.loads((REPO / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert NAME.match(w["name"]) and len(w["why"]) <= 200
        assert (PB / "traffic" / f"{w['traffic']}.json").exists()
        assert (PB / "checks" / f"{w['name']}.json").exists()
    names = [m["name"] for m in B["end_to_end"] + B["per_layer"]]
    assert len(set(names)) == len(names)
    assert {"solve_s", "setup_s"} <= {m["name"] for m in B["end_to_end"]}
    for m in B["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert any((PB / "metrics" / f"{n.replace('.', '_')}.py").exists()
                   for n in (m["name"], m["name"].split(".")[0]))
    cells = [w["name"] for w in B["workloads"]]
    e2e = {w: {m["name"] for m in B["end_to_end"] if w in m.get("workloads", cells)}
           for w in cells}
    for w in cells:
        assert "setup_s" in e2e[w] and len(e2e[w]) >= 2
    for m in B["per_layer"]:
        assert "\n" not in m["layer"]
        # each cell that reads the metric reports the end-to-end metric it moves
        assert all(m["moves"] in e2e[w] for w in m.get("workloads", cells))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
