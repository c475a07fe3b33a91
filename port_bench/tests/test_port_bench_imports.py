"""What a run imports: nothing whose top-level name is jax, jaxlib, flax or
the JAX package (compared whole: the port's name only begins with the JAX
package's), and a reference that loads nothing of the port."""
import json
import subprocess
import sys

from port_bench.tests.cells import PB, REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "fem_elastoplasticity_tpu"}


def loaded_top_names(code: str) -> set:
    probe = (code + "\nimport json, sys\n"
             "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    p = subprocess.run([sys.executable, "-c", probe], cwd=REPO, capture_output=True, text=True,
                       timeout=300, env={"PATH": "/usr/bin:/bin", "USE_FLAX": "0"})
    assert p.returncode == 0, p.stderr
    return set(json.loads(p.stdout.strip().splitlines()[-1]))


def test_harness_metrics_entries_and_port_load_no_jax():
    metrics = [f.stem for f in (PB / "metrics").glob("*.py") if f.stem != "__init__"]
    entries = [f.stem for f in (PB / "entries").glob("*.py") if f.stem != "__init__"]
    code = "\n".join(
        ["import port_bench.run, port_bench.harness, port_bench.calibrate, port_bench.trace",
         "import fem_elastoplasticity_tpu_torch.models.tsx_tunnel",
         "import fem_elastoplasticity_tpu_torch.models.footing",
         "import fem_elastoplasticity_tpu_torch.utils.convert"]
        + [f"import port_bench.metrics.{m}" for m in metrics]
        + [f"import port_bench.entries.{e}" for e in entries])
    names = loaded_top_names(code)
    assert "fem_elastoplasticity_tpu_torch" in names
    assert not names & FORBIDDEN


def test_reference_loads_nothing_of_the_port():
    refs = [f.stem for f in (PB / "reference").glob("*.py") if f.stem != "__init__"]
    names = loaded_top_names("\n".join(f"import port_bench.reference.{r}" for r in refs))
    assert not names & (FORBIDDEN | {"fem_elastoplasticity_tpu_torch"})
