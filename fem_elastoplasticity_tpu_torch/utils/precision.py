"""Device resolution and the dtype policy of the port.

Replaces `fem_elastoplasticity_tpu/utils/precision.py`, which enables x64
and sets XLA flags.  Here nothing global happens at import: callers resolve
a device once with `resolve_device` and pass it everywhere with `device=`.
An entry point given no device runs on the card and raises where there is
none; the host is only ever chosen by name.

On CUDA, `resolve_device` switches TF32 off for matmuls and convolutions and
sets f32 matmul precision to "highest".  TF32 keeps a 10-bit mantissa; the
f32 products of the df32 preset (`Ki @ rhs`, the Woodbury matmuls) would
silently drop to it on Hopper and change the Newton iteration counts.

Precisions (`TsxTunnelConfig.precision`, `FootingConfig.precision`):
  * "native" — every tensor in the config's dtype: float64 for parity,
    float32 for the `fast_f32` presets, whose return map is kernel K2.
  * "df32"   — the JAX package carries this state as two-float32 pairs
    because a TPU has no f64.  The H100 has f64 in hardware, so the port
    carries the same state as float64: the load-stepping state and the
    Newton residual (strain, return map, force).  The consistent tangent,
    its dense assembly and factorizations, the explicit elastic inverse,
    the Woodbury solve, the increment dU and the criterion norms stay
    float32, exactly where the JAX package runs them in f32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Union

import torch

PRECISIONS = ("native", "df32")


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device to run on: `device` if given, else the current CUDA card.
    The port runs on the card unless the caller asks for the CPU
    (device="cpu"): with no device given and no card visible it raises
    RuntimeError.  Configures CUDA matmul precision (module doc)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA card is visible: the port runs on the card; pass "
                "device='cpu' to run on the host"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
    return device


class DtypePolicy(NamedTuple):
    """Dtypes of one precision preset.

    state:   load-stepping state and the Newton residual pipeline.
    tangent: consistent tangent, dense assembly, factorizations, dU and
             the criterion norms.
    """

    state: torch.dtype
    tangent: torch.dtype


def dtype_policy(precision: str, dtype: str) -> DtypePolicy:
    """Resolve a config's (precision, dtype) pair to the port's dtypes."""
    if precision == "df32":
        if dtype != "float32":
            raise ValueError("precision='df32' runs on float32 heads (dtype='float32')")
        return DtypePolicy(state=torch.float64, tangent=torch.float32)
    if precision != "native":
        raise ValueError(f"precision {precision!r} not in {PRECISIONS}")
    if dtype == "float32":
        # the pure-f32 presets: the return map runs in kernel K2
        return DtypePolicy(state=torch.float32, tangent=torch.float32)
    if dtype != "float64":
        raise NotImplementedError(f"precision='native' with dtype={dtype!r}")
    return DtypePolicy(state=torch.float64, tangent=torch.float64)
