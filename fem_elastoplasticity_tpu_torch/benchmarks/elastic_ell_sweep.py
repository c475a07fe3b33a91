"""Elastic excavation solves at scale on the assembled hierarchy.

Port of `fem_elastoplasticity_tpu/benchmarks/elastic_ell_sweep.py`.  The
same problem as `elastic_df32_sweep` (an f64-grade elastic solve
K u = -F0 a refinement level: f32 MG-PCG corrections, three passes of
iterative refinement against the f64 residual), but every V-cycle and CG
operator application runs on the assembled elastic hierarchy
(`solve.multigrid.build_hierarchy_ell`, fine-RCM node order, and
`make_vcycle_ell`; the CG operator is the fine level's `op` through
`ops.spmv.sp_matvec`).  fmt="slot": node blocks, the CG product and the
transfers through K3, the smoother through K4, on levels of 500,000 rows or
more (level 5) K5 on bf16 blocks; fmt="ell": sliced ELL operators, every
product and transfer through K6.

The JAX record's `J_op` (a windowed-ELL / slot layout figure) is replaced
by `op_layout`, the fine operator's layout in the port: for "slot" its node
blocks (`node_blocks`) and the most a node has (`width`), for "ell" the row
cap (`cap`), the least and largest slice width (`slice_widths`) and the
tail entries (`tail`).  Setup and walls as in `elastic_df32_sweep`.

    python -m fem_elastoplasticity_tpu_torch.benchmarks.elastic_ell_sweep [levels...] [--cpu]
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from ..models.config import TsxTunnelConfig
from ..models.materials import lame_moduli
from ..models.tsx_tunnel import _DATA, _free_of, initial_state
from ..ops import assembly as asm
from ..ops import spmv
from ..ops.elements import ElementType, volume_element
from ..solve import multigrid as mgm
from ..utils.precision import resolve_device
from ..utils.timing import host_sync
from .elastic_df32_sweep import refined_solve, timed_record


def op_layout(op) -> dict:
    """The fine operator's layout figures (module docstring)."""
    if isinstance(op, spmv.EllMatrix):
        w = op.widths()
        return {"format": "ell", "cap": op.cap, "slice_widths": [int(w.min()), int(w.max())],
                "tail": int(op.tail_values.shape[0])}
    return {"format": "slot", "node_blocks": int(op.block_cols.shape[0]), "width": op.width}


def run_elastic_ell_sweep(levels=(0, 1, 2, 3, 4, 5), reps: int = 3,
                          verbose=True, fmt: str = "slot", device=None):
    device = resolve_device(device)
    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    s0, _ = initial_state(cfg)
    ref = volume_element(ElementType.P1)

    with np.load(_DATA) as raw:
        coords0, elems0 = raw["coords"].astype(np.float64), raw["elems"]
    results = []
    for level in levels:
        t0 = time.perf_counter()
        hier, _, coarse = mgm.build_hierarchy_ell(
            coords0, elems0, level, _free_of, shear, bulk, ref, device=device, fmt=fmt)
        # the permuted fine mesh, for the f64 residual's geometry
        top = coarse["levels"][-1]
        geom = asm.compute_geometry(torch.as_tensor(top["coords"], device=device), top["elems"],
                                    ref)
        free = torch.as_tensor(top["free"], device=device)
        op = hier.levels[-1].op
        pre = mgm.make_vcycle_ell(hier, nu=2)
        host_sync(hier.inv0)
        t_setup = time.perf_counter() - t0

        def run():
            return refined_solve(geom, free, s0, lambda v: spmv.sp_matvec(op, v), pre,
                                 shear, bulk)

        rec = timed_record(level, top["elems"].shape[0], 2 * top["coords"].shape[0], t_setup,
                           run, reps)
        rec["op_layout"] = op_layout(op)
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    lv = tuple(int(x) for x in sys.argv[1:] if x != "--cpu") or (0, 1, 2, 3, 4, 5)
    run_elastic_ell_sweep(levels=lv, device="cpu" if "--cpu" in sys.argv else None)
