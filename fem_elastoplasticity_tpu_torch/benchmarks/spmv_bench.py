"""Sliced-ELL product (K6) against the matrix-free product on the card.

Port of `fem_elastoplasticity_tpu/benchmarks/spmv_bench.py`.  The tsx mesh
is refined `level` times and put in reverse Cuthill-McKee node order; its
elastic stiffness (no constraints) is assembled on the host
(`ops.spmv.build_elastic_csr`) and laid out as the sliced ELL operator of
kernel K6 (`ops.spmv.build_ell`, f32).  The record holds one K6 product
y = K v against the matrix-free f32 product (`ops.assembly.tangent_matvec`)
on the same mesh and the same seeded v: both times, their ratio, and the
largest difference of the two products over the largest entry of the
matrix-free one (`max_rel_diff`).  The matrix-free product runs on the f32
heads of the f64 geometry, as the df32 paths' tangents do: the JAX bench
builds its geometry from f32 coordinates, whose rounding on the small
elements of refined meshes moves the product by about 2x a level (on the
CPU, 1.9e-6 of max |y| at level 3 against 2.5e-7 from the f32 heads; the
sliced ELL product is within 2.0e-7 of the f64 one at levels 0-3).

Times come from `utils.timing.cuda_ms` on the card: `value` and
`matrix_free_ms` are device times (the calls replayed from a CUDA graph),
`value_eager_ms` and `matrix_free_eager_ms` the times with the host's
launches.  On the host (`device="cpu"`, K6's plain version) both are
`utils.timing.time_call` medians.  The JAX record's windowed-ELL layout
keys (`J`, `deg`) are replaced by the sliced layout's: `cap` (entries a
row holds in its slice; the rest are its tail), `slice_widths` (the least
and the largest slice width) and `tail` (tail entries).

    python -m fem_elastoplasticity_tpu_torch.benchmarks.spmv_bench [level] [--cpu]
"""
import json
import sys
import time

import numpy as np
import torch

from ..mesh.refine import refine_uniform
from ..models.materials import elastic_tangent_lanes, lame_moduli
from ..models.tsx_tunnel import _DATA
from ..ops import assembly as asm
from ..ops import spmv
from ..ops.elements import ElementType, volume_element
from ..utils.precision import resolve_device
from ..utils.timing import cuda_ms, time_call


def main(level: int = 5, reps: int = 10, device=None) -> dict:
    """Print and return the record of the tsx mesh at `level`; `reps`
    calls of each product are timed."""
    device = resolve_device(device)
    with np.load(_DATA) as raw:
        coords, elems = raw["coords"].astype(np.float64), raw["elems"]
    for _ in range(level):
        coords, elems = refine_uniform(coords, elems)
    n_n = coords.shape[0]

    t0 = time.perf_counter()
    order = spmv.rcm_node_order(elems, n_n)
    coords2, elems2, _ = spmv.permute_mesh(coords, elems, order)
    shear, bulk = lame_moduli(60000.0, 0.2)
    ref = volume_element(ElementType.P1)
    K = spmv.build_elastic_csr(coords2, elems2, ref, shear, bulk)
    A = spmv.build_ell(K, device, np.float32)
    setup = time.perf_counter() - t0

    v = torch.as_tensor(np.random.default_rng(0).standard_normal(2 * n_n), dtype=torch.float32,
                        device=device)
    # matrix-free reference on the same (permuted) mesh: f32, on the f32
    # heads of the f64 geometry (module docstring)
    geom = asm.compute_geometry(torch.as_tensor(coords2, device=device), elems2,
                                ref).to(torch.float32)
    d = elastic_tangent_lanes(shear, bulk, geom.n_int, torch.float32, device)

    def ell():
        return spmv.ell_matvec(A, v)

    def mf():
        return asm.tangent_matvec(geom, d, v)

    y_mf = mf()
    rel = float((ell() - y_mf).abs().max() / y_mf.abs().max())
    if device.type == "cuda":
        t_ell, t_ell_eager = cuda_ms(ell, reps=reps)
        t_mf, t_mf_eager = cuda_ms(mf, reps=reps)
    else:
        t_ell = t_ell_eager = 1e3 * time_call(ell, reps=reps)
        t_mf = t_mf_eager = 1e3 * time_call(mf, reps=reps)
    widths = A.widths()
    rec = {
        "metric": "ell_matvec_ms",
        "level": level,
        "n_dofs": A.n_rows,
        "nnz": int(K.nnz),
        "cap": A.cap,
        "slice_widths": [int(widths.min()), int(widths.max())],
        "tail": int(A.tail_values.shape[0]),
        "value": t_ell,
        "unit": "ms",
        "matrix_free_ms": t_mf,
        "speedup": t_mf / t_ell,
        "setup_s": setup,
        "value_eager_ms": t_ell_eager,
        "matrix_free_eager_ms": t_mf_eager,
        "max_rel_diff": rel,
    }
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--cpu"]
    main(int(args[0]) if args else 5, device="cpu" if "--cpu" in sys.argv else None)
