"""Structured per-step solver metrics.

Port of `fem_elastoplasticity_tpu/utils/metrics.py`: the solver returns
dense history arrays, and this module turns them into structured records
(a dict per accepted load step, a run summary, JSON lines) for logging,
dashboards or regression tracking, after the run.

A result is read by duck type: `n_steps`, `n_newton_total`, `n_plastic`,
`zeta_hist` and `monitor_hist`.  The port's `TsxResult` calls its monitor
history `displ_hist` and `FootingResult` `pressure_hist`; `monitor_hist`
falls back to those, so the results go in as they are.
"""
from __future__ import annotations

import json
import logging
from typing import Dict, Iterable, List

import numpy as np

log = logging.getLogger("fem_elastoplasticity_tpu_torch")


def _monitor_hist(result) -> np.ndarray:
    for name in ("monitor_hist", "displ_hist", "pressure_hist"):
        if hasattr(result, name):
            return np.asarray(getattr(result, name))
    raise AttributeError(f"{type(result).__name__} has no monitor history")


def step_records(result, monitor_name: str = "monitor") -> List[Dict]:
    """A load-stepping result -> one dict per accepted load step."""
    n = int(result.n_steps)
    zh = np.asarray(result.zeta_hist)
    mh = _monitor_hist(result)
    recs = []
    for i in range(min(n, len(zh))):
        if zh[i] == 0.0 and i > 0:
            continue  # unused slot (step0 offset)
        recs.append({"step": i, "zeta": float(zh[i]), monitor_name: float(mh[i])})
    return recs


def summarize(result, monitor_name: str = "monitor") -> Dict:
    """Run-level summary (counts, final state) as one dict."""
    n = int(result.n_steps)
    return {
        "n_steps": n,
        "n_newton_total": int(result.n_newton_total),
        "n_plastic": int(result.n_plastic),
        "zeta_final": float(np.asarray(result.zeta_hist).max()),
        f"{monitor_name}_final": float(_monitor_hist(result)[n - 1] if n > 0 else 0.0),
    }


def log_run(result, monitor_name: str = "monitor", level=logging.INFO) -> None:
    """Emit the summary and the per-step records through the stdlib logger."""
    log.log(level, "run summary: %s", json.dumps(summarize(result, monitor_name)))
    for rec in step_records(result, monitor_name):
        log.log(level, "step: %s", json.dumps(rec))


def write_jsonl(path: str, records: Iterable[Dict]) -> None:
    with open(path, "w") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")
