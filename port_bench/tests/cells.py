"""Tiny cells of the two entries, built in a temporary directory beside
the real BENCHMARK.json's shape: the harness finds them by name."""
from __future__ import annotations

import hashlib
import json
import pathlib
import shutil

REPO = pathlib.Path(__file__).resolve().parents[2]
PB = REPO / "port_bench"


def make_root(tmp: pathlib.Path, kind: str) -> tuple:
    """(root, workload): a tsx cell at refine level 1 (3,678 DOFs) or a
    footing cell at level 2 (3,362 DOFs) resuming from a checkpoint that
    the port banks here after three trips."""
    root = tmp / "root"
    for sub in ("configs", "traffic", "checks"):
        (root / "port_bench" / sub).mkdir(parents=True, exist_ok=True)
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    if kind == "tsx":
        conf = json.loads((PB / "configs" / "tsx_l5.json").read_text())
        conf.update(name="tsx_tiny", refine_levels=1)
        base_cell, traffic, checks = "tsx_l5.excavation", "excavation", "tsx_l5.excavation"
    else:
        conf = json.loads((PB / "configs" / "footing_l5.json").read_text())
        ckpt = root / "tiny_ckpt.npz"
        bank_footing(ckpt, level=2)
        conf.update(name="footing_tiny", level=2, checkpoint="tiny_ckpt.npz",
                    checkpoint_sha256=hashlib.sha256(ckpt.read_bytes()).hexdigest())
        base_cell, traffic, checks = ("footing_l5.plastic_trip", "plastic_trip",
                                      "footing_l5.plastic_trip")
    name = conf["name"]
    workload = f"{name}.tiny_mix"
    (root / "port_bench" / "configs" / f"{name}.json").write_text(json.dumps(conf))
    dst = root / "port_bench"
    shutil.copy(PB / "traffic" / f"{traffic}.json", dst / "traffic" / "tiny_mix.json")
    shutil.copy(PB / "checks" / f"{checks}.json", dst / "checks" / f"{workload}.json")
    cell = next(w for w in bench["workloads"] if w["name"] == base_cell)
    conf_entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    bench["configs"] = [dict(conf_entry, name=name, file=f"port_bench/configs/{name}.json")]
    bench["workloads"] = [dict(cell, name=workload, config=name, traffic="tiny_mix")]
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "workloads" in m:
            m["workloads"] = [workload] if base_cell in m["workloads"] else []
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root, workload


def bank_footing(path: pathlib.Path, level: int) -> None:
    """A checkpoint of the footing's tangent-multigrid preset after three
    load trips, written by the port."""
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
    from fem_elastoplasticity_tpu_torch.utils.convert import save_checkpoint

    run, _ = footing.build_df32(FootingConfig.fast_scale(level, max_trips=3), device="cpu")
    save_checkpoint(path, run().carry)
