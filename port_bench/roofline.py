"""Peaks of the card and the bytes of the port's node-block kernels: the
yardstick of the roofline metrics, frozen here.

Copied from the port's smoke (`chip_smoke.py`: the peaks, `bound_ms`,
`sweep_cost`).  The peaks are NVIDIA's H100 SXM data sheet: 3.35 TB/s of
HBM3 and 67 TFLOP/s in float32 outside the tensor cores, both at the full
700 W power limit; a card set below it (the run prints `power.limit`)
reads a lower share.  A kernel's bound counts each input byte read once and
each output byte written once.
"""
from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12


def bound_s(n_bytes: float, flops: float) -> float:
    """Least seconds for moving n_bytes once and doing flops at the peaks."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_F32_FLOPS)


def sweep_cost(n: int, nnz: int, n_blocks: int, value_bytes: int, update: bool):
    """(CSR bytes, node-block layout bytes, operations) of one sweep (K4 on
    f32 blocks, K5 on bf16) on an operator of n rows: the CSR pays a value
    and an int32 column an entry and n + 1 row offsets, the layout 4 values
    and one int32 node column a block and n/2 + 1 node offsets; both read
    z, r, mask (and msf, mpr with the update) and write out."""
    vec = 4 * n * (6 if update else 4)
    csr = (value_bytes + 4) * nnz + 4 * (n + 1) + vec
    layout = (4 * value_bytes + 4) * n_blocks + 4 * (n // 2 + 1) + vec
    return csr, layout, 2 * nnz + (8 if update else 2) * n


def product_cost(n: int, n_cols: int, n_blocks: int, value_bytes: int):
    """(node-block layout bytes, operations) of K3's product y = B x: the
    blocks and node offsets as in `sweep_cost`, x read and y written once."""
    layout = (4 * value_bytes + 4) * n_blocks + 4 * (n // 2 + 1) + 4 * (n_cols + n)
    return layout, 8 * n_blocks
