"""Checkpoint / resume of load-stepping solver state as a flat npz file.

Port of `fem_elastoplasticity_tpu/utils/checkpoint.py`: `SolverCheckpoint`
holds the JAX package's 13 fields in its order, each under its own name in
the npz (`save`, `load`), so that a file written by either package loads
in the other.  Two fields follow them for the deflated CG routes
(cg_deflate > 0): the recycled basis `defl_w` and the next slot of its
ring `defl_ring`, written only where the run has a basis, under keys the
JAX package's `load` does not read.

`from_carry` and `to_carry` convert to and from the port's resume carry
(`solve.newton.carry_of`, `CARRY_KEYS`; `run(resume=...)` of a build):
every f64 array and number is kept exactly, so a run resumed from a file
takes the uninterrupted run's trajectory bit for bit.

This is not the format of the chunked runs (`solve/chunked.py`,
`utils.convert.save_checkpoint` / `load_checkpoint`): that one is the JAX
df32 stepper's carry, its f64 values split into `key__hi` / `key__lo` f32
pairs (the port adds an exact f64 copy of each), where this one stores
each field as one array under its plain name.
"""
from __future__ import annotations

import pathlib
from typing import NamedTuple, Optional

import numpy as np
import torch

# the JAX package's fields, in its order
JAX_FIELDS = (
    "u", "u_old", "u_it", "ep", "zeta_old", "d_zeta", "d_zeta_old", "step", "aux",
    "zeta_hist", "monitor_hist", "nits_total", "ncg_total",
)


class SolverCheckpoint(NamedTuple):
    """Resumable snapshot of the load-stepping carry (`solve.newton`)."""

    u: np.ndarray  # (2*n_n,)
    u_old: np.ndarray
    u_it: np.ndarray
    ep: np.ndarray  # (4, n_int)
    zeta_old: float
    d_zeta: float
    d_zeta_old: float
    step: int
    aux: float
    zeta_hist: np.ndarray
    monitor_hist: np.ndarray
    nits_total: int
    ncg_total: int = 0  # cumulative CG iterations (0 for dense solvers)
    defl_w: Optional[np.ndarray] = None  # (2*n_n, cg_deflate) float32 deflation basis
    defl_ring: int = 0  # the basis column the next harvest overwrites


def save(path: str, ckpt: SolverCheckpoint) -> None:
    """Write `ckpt` as a compressed npz: the 13 JAX fields, and the
    deflation basis and ring where `defl_w` is set."""
    p = pathlib.Path(path)
    p.parent.mkdir(parents=True, exist_ok=True)
    fields = ckpt._asdict()
    if ckpt.defl_w is None:
        fields = {k: fields[k] for k in JAX_FIELDS}
    np.savez_compressed(p, **fields)


def load(path: str) -> SolverCheckpoint:
    """Read a checkpoint written by `save` here or in the JAX package."""
    with np.load(path) as raw:
        return SolverCheckpoint(
            u=raw["u"],
            u_old=raw["u_old"],
            u_it=raw["u_it"],
            ep=raw["ep"],
            zeta_old=float(raw["zeta_old"]),
            d_zeta=float(raw["d_zeta"]),
            d_zeta_old=float(raw["d_zeta_old"]),
            step=int(raw["step"]),
            aux=float(raw["aux"]),
            zeta_hist=raw["zeta_hist"],
            monitor_hist=raw["monitor_hist"],
            nits_total=int(raw["nits_total"]),
            ncg_total=int(raw["ncg_total"]) if "ncg_total" in raw else 0,
            defl_w=raw["defl_w"] if "defl_w" in raw else None,
            defl_ring=int(raw["defl_ring"]) if "defl_ring" in raw else 0,
        )


def _numpy(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def from_carry(carry: dict) -> SolverCheckpoint:
    """The port's resume carry (`solve.newton.carry_of`) -> a checkpoint on
    the host: arrays as numpy in their dtype, the scalars as Python
    numbers."""
    defl_w = carry.get("defl_w")
    return SolverCheckpoint(
        u=_numpy(carry["u"]), u_old=_numpy(carry["u_old"]), u_it=_numpy(carry["u_it"]),
        ep=_numpy(carry["ep"]), zeta_old=float(carry["zeta_old"]),
        d_zeta=float(carry["d_zeta"]), d_zeta_old=float(carry["d_zeta_old"]),
        step=int(carry["step"]), aux=float(carry["aux"]),
        zeta_hist=_numpy(carry["zeta_hist"]), monitor_hist=_numpy(carry["monitor_hist"]),
        nits_total=int(carry["nits_total"]), ncg_total=int(carry.get("ncg_total", 0)),
        defl_w=None if defl_w is None else _numpy(defl_w),
        defl_ring=int(carry.get("defl_ring", 0)),
    )


def to_carry(ckpt: SolverCheckpoint, device=None) -> dict:
    """A checkpoint -> the port's resume carry on `device`: arrays as f64
    tensors (exact: the state is f64, or f32 on the native f32 presets),
    the deflation basis as an f32 tensor where the checkpoint has one."""
    as_f64 = lambda x: torch.as_tensor(np.asarray(x, np.float64), device=device)  # noqa: E731
    carry = dict(
        u=as_f64(ckpt.u), u_old=as_f64(ckpt.u_old), u_it=as_f64(ckpt.u_it), ep=as_f64(ckpt.ep),
        zeta_old=float(ckpt.zeta_old), d_zeta=float(ckpt.d_zeta),
        d_zeta_old=float(ckpt.d_zeta_old), step=int(ckpt.step), aux=float(ckpt.aux),
        zeta_hist=as_f64(ckpt.zeta_hist), monitor_hist=as_f64(ckpt.monitor_hist),
        nits_total=int(ckpt.nits_total), ncg_total=int(ckpt.ncg_total),
    )
    if ckpt.defl_w is not None:
        carry.update(defl_w=torch.as_tensor(np.asarray(ckpt.defl_w, np.float32), device=device),
                     defl_ring=int(ckpt.defl_ring))
    return carry
