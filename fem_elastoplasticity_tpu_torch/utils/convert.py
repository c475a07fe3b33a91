"""Carry state between the JAX package and the port.

The JAX package's df32 preset holds f64 quantities as pairs of f32 arrays
(hi + lo).  These functions take its arrays as numpy (or anything with
`.hi`/`.lo`) and build the port's f64 tensors, and back, so that both
packages can compute from identical inputs:

* `geometry_from_df`: a `GeometryDF` (B_hi + B_lo, w_hi + w_lo) -> the
  port's f64 `Geometry`;
* `carry_from_jax`: a load-stepping carry in `solve/chunked.py carry_of`
  format, or as `save_checkpoint` writes it (`key__hi`/`key__lo`), -> the
  port's resume carry;
* `carry_to_jax`: the inverse, in `save_checkpoint` format;
* `load_checkpoint` / `save_checkpoint`: the npz checkpoint of
  `solve/chunked.py` (`:58`, `:45`) as a port carry, and a port carry
  written in that format (atomic replace), so that either package resumes
  the other's run (`checkpoints/footing_l5_k16.npz`); beside the JAX
  format the port writes each f64 value exactly (`EXACT_SUFFIX`), so that
  a port run resumed from its own file keeps its bits;
* `hierarchy_from_numpy`: the host data of the JAX package's multigrid
  hierarchy -> the port's device hierarchy, so that V-cycle and CG tests run
  both packages on identical operators.
"""
from __future__ import annotations

import os
from typing import Mapping, Sequence

import numpy as np
import torch

from ..ops.assembly import Geometry, make_geometry
from ..ops.assembly_df import split_f64_np

# carry fields the JAX df32 stepper holds as DF pairs
DF_KEYS = ("u", "u_old", "u_it", "ep", "zeta_old", "d_zeta", "d_zeta_old", "monitor_hist")
INT_KEYS = ("step", "nits_total", "ncg_total", "defl_ring")
ARRAY_KEYS = ("u", "u_old", "u_it", "ep", "zeta_hist", "monitor_hist")
# the recycled deflation basis: an f32 array in both packages
F32_ARRAY_KEYS = ("defl_w",)
# the suffix of the exact f64 copy of a carry value in a port checkpoint.
# The JAX package's loader reads a `__lo` array only beside its `__hi`, so
# it skips these keys and reads the pairs
EXACT_SUFFIX = "__f64__lo"


def df_to_f64(hi, lo) -> np.ndarray:
    """(hi, lo) f32 pair -> f64, exactly."""
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def geometry_from_df(
    B_hi, B_lo, w_hi, w_lo, edofs, n_nodes: int, n_q: int, n_real: int, device=None
) -> Geometry:
    """The JAX package's double-float geometry as the port's f64 Geometry."""
    as_t = lambda x: torch.as_tensor(x, dtype=torch.float64, device=device)  # noqa: E731
    return make_geometry(
        as_t(df_to_f64(B_hi, B_lo)), as_t(df_to_f64(w_hi, w_lo)),
        np.asarray(edofs), n_nodes, n_q, n_real,
    )


def _value(carry: Mapping, key: str):
    if key + "__hi" in carry:
        return df_to_f64(carry[key + "__hi"], carry[key + "__lo"])
    v = carry[key]
    if hasattr(v, "hi") and hasattr(v, "lo"):
        return df_to_f64(v.hi, v.lo)
    return np.asarray(v)


def carry_from_jax(carry: Mapping, device=None) -> dict:
    """JAX load-stepping carry -> the port's resume carry (f64 tensors for
    arrays, the deflation basis `defl_w` as an f32 tensor, Python floats and
    ints for scalars)."""
    out = {}
    keys = {k[: -len("__hi")] if k.endswith("__hi") else k for k in carry
            if not k.endswith("__lo")}
    for key in sorted(keys):
        v = _value(carry, key)
        if key in ARRAY_KEYS:
            out[key] = torch.as_tensor(np.asarray(v, np.float64), device=device)
        elif key in F32_ARRAY_KEYS:
            out[key] = torch.as_tensor(np.asarray(v, np.float32), device=device)
        elif key in INT_KEYS:
            out[key] = int(v)
        else:
            out[key] = float(v)
    return out


def carry_to_jax(carry: Mapping) -> dict:
    """The port's carry -> `save_checkpoint` format of the JAX df32 stepper:
    DF fields split into `key__hi`/`key__lo` f32 arrays, `zeta_hist`, `aux`
    and `defl_w` as f32, the counters as int64 and `defl_ring` as int32 (the
    JAX carry's types).  An f64 value keeps 48 of its 53 bits in a pair."""
    out = {}
    for key, v in carry.items():
        x = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if key in DF_KEYS:
            out[key + "__hi"], out[key + "__lo"] = split_f64_np(x)
        elif key in INT_KEYS:
            out[key] = np.asarray(int(x), np.int32 if key == "defl_ring" else np.int64)
        else:
            out[key] = np.asarray(x, np.float32)
    return out


def load_checkpoint(path, device=None) -> dict:
    """A checkpoint npz of the JAX package (`solve/chunked.py
    save_checkpoint`, or `save_checkpoint` here) -> the port's resume carry
    on `device` (`carry_from_jax`): DF pairs summed exactly into f64, the
    deflation basis and ring included; where the file holds a value's exact
    f64 copy (`EXACT_SUFFIX`, written by the port), that copy."""
    with np.load(path) as raw:
        files = {k: raw[k] for k in raw.files}
    out = carry_from_jax(files, device=device)
    for k, v in files.items():
        if k.endswith(EXACT_SUFFIX):
            key = k[: -len(EXACT_SUFFIX)]
            out[key] = (torch.as_tensor(v, device=device) if key in ARRAY_KEYS
                        else float(v))
    return out


def save_checkpoint(path, carry: Mapping) -> None:
    """Write a port carry (`solve.newton.carry_of`) as the JAX package's
    checkpoint npz (`carry_to_jax`), with the exact f64 copy of every
    float64 value beside it (`EXACT_SUFFIX`; the pairs keep 48 of its 53
    bits), atomically: to `path`.tmp.npz, then renamed over `path`."""
    flat = carry_to_jax(carry)
    for key, v in carry.items():
        if key in INT_KEYS or key in F32_ARRAY_KEYS:
            continue
        x = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        if x.dtype == np.float64:
            flat[key + EXACT_SUFFIX] = x
    tmp = str(path) + ".tmp.npz"
    np.savez(tmp, **flat)
    os.replace(tmp, str(path))


def hierarchy_from_numpy(levels: Sequence[Mapping], inv0, free_idx0, device=None,
                         pack_bf16="auto"):
    """The JAX package's hierarchy as the port's `solve.multigrid.Hierarchy`.

    levels[l]: the host data `build_hierarchy_ell(..., collect_levels=True)`
    keeps per level (`coarse["levels"][l]`: scipy `K`, `free`, scipy `P` or
    None) plus `inv`, that level's (n_n, 2, 2) damped block inverse
    (`arrays[l]["inv"]`), all as numpy or scipy.  inv0, free_idx0: the
    coarse solve's explicit inverse and free DOFs (`coarse["inv0"]`,
    `coarse["free_idx0"]`).  pack_bf16: as the JAX build's argument of the
    same name (`solve.multigrid.packs_bf16`).
    """
    from ..solve.multigrid import hierarchy_to_device

    host = [
        dict(K=lv["K"], free=np.asarray(lv["free"]), inv=np.asarray(lv["inv"]), P=lv.get("P"))
        for lv in levels
    ]
    return hierarchy_to_device(host, np.asarray(inv0), np.asarray(free_idx0), device,
                               pack_bf16)
