"""Chunked, checkpointed execution of a load-stepping run.

Port of `fem_elastoplasticity_tpu/solve/chunked.py`.  `run_chunked` drives
a stepper built with a small `max_trips` (the chunk) through its resume
path, one chunk after another, each from the carry of the one before: the
trajectory is the single run's, bit for bit.  With a checkpoint path each
chunk's carry is written to disk (`utils.convert.save_checkpoint`, the JAX
package's npz format with the exact f64 values beside it), and a run that
finds the file continues from it (`utils.convert.load_checkpoint`), in a
new process too.  The load loop stays on the host as in every port run;
chunking is all this module adds.  A checkpoint written by the JAX
package's `solve/chunked.py` resumes here as well.
"""
from __future__ import annotations

import os
from typing import Callable

from ..utils.convert import load_checkpoint, save_checkpoint
from .newton import carry_of


def result_carry(res) -> dict:
    """The resume carry of a chunk's result: a `FootingResult`'s `carry`,
    or `newton.carry_of` of a `LoadSteppingResult`."""
    carry = getattr(res, "carry", None)
    return carry if isinstance(carry, dict) else carry_of(res)


def run_chunked(run: Callable, *, zeta_max: float, d_zeta_min: float, max_chunks: int = 200,
                checkpoint_path=None):
    """Drive `run(resume=...)` chunk by chunk until the schedule ends.

    The loop stops when the carried load factor reaches `zeta_max` (with
    the stepper's 1e-12 slack) or the step size falls below `d_zeta_min`,
    the stepper's own stop, or after `max_chunks` chunks past the first.
    Returns the last chunk's result."""
    resume = None
    if checkpoint_path is not None and os.path.exists(checkpoint_path):
        resume = load_checkpoint(checkpoint_path)
    res = run(resume=resume)
    for _ in range(max_chunks):
        carry = result_carry(res)
        if checkpoint_path is not None:
            save_checkpoint(checkpoint_path, carry)
        if carry["zeta_old"] >= zeta_max - 1e-12 or carry["d_zeta"] < d_zeta_min:
            break
        res = run(resume=carry)
    return res
