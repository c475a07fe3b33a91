"""Elastic-assembly refinement sweep.

Port of `fem_elastoplasticity_tpu/benchmarks/assembly_sweep.py`.  The
reference timed `get_elastic_stiffness_matrix` over 8 MATLAB uniform
refinements (`comparison_assembly_P1_2D_elasticity.py:44-85`).  Here the
tsx mesh is red-refined level by level and the elastic operator pipeline
is timed on the device at each level: the geometry from the coordinates
(`compute_geometry`), the elastic tangent lanes, the element stiffness
and the matrix-free product K u (`tangent_matvec`), in f64.  The host
builds the element table and the DOF gather map once a level (setup, not
timed); the timed call launches device work only, one pipeline a call.

Times come from `utils.timing.cuda_ms` on the card: `assemble_apply_s` is
the device time of one pipeline (the calls replayed from a CUDA graph) and
`assemble_apply_eager_s` the time with the host's launches (the calls
launched one after another from Python); `gdof_per_s` divides the DOFs by
the device time.  On the host (`device="cpu"`) both are the median wall
of `utils.timing.time_call`.  No kernel of the port's own runs here.

    python -m fem_elastoplasticity_tpu_torch.benchmarks.assembly_sweep [--cpu]
"""
from __future__ import annotations

import json
import sys
from typing import List

import numpy as np
import torch

from ..mesh.refine import refine_uniform
from ..models.materials import elastic_tangent_lanes, lame_moduli
from ..models.tsx_tunnel import tsx_mesh
from ..ops import assembly as asm
from ..ops.elements import ElementType, tables, volume_element
from ..utils.precision import resolve_device
from ..utils.timing import cuda_ms, time_call


def run_assembly_sweep(
    levels: int = 5, reps: int = 5, verbose: bool = True, device=None
) -> List[dict]:
    """One record a refinement level 0..`levels`: elements, DOFs, the
    pipeline's time (`assemble_apply_s`, device time on the card) and
    GDOF/s; `reps` calls are timed a level."""
    device = resolve_device(device)
    shear, bulk = lame_moduli(60000.0, 0.2)
    ref = volume_element(ElementType.P1)
    tab = tables(ref)._replace(dN=torch.as_tensor(ref.dN, device=device),
                               w=torch.as_tensor(ref.w, device=device))
    mesh0 = tsx_mesh(ElementType.P1)
    coords, elems = mesh0.coords, mesh0.elems

    results = []
    for level in range(levels + 1):
        if level > 0:
            coords, elems = refine_uniform(coords, elems)
        n_n, n_e = coords.shape[0], elems.shape[0]
        c = torch.as_tensor(coords, device=device)
        e = torch.as_tensor(np.asarray(elems, np.int64), device=device)
        u = torch.ones(2 * n_n, dtype=c.dtype, device=device)
        like = asm.compute_geometry(c, elems, ref)  # the host's index maps

        def assemble_and_apply():
            geom = asm.compute_geometry(c, e, tab, like=like)
            D = elastic_tangent_lanes(shear, bulk, geom.n_int, c.dtype, device)
            ke = asm.element_stiffness(geom, D)
            return asm.tangent_matvec(geom, D, u), ke

        if device.type == "cuda":
            dev_ms, eager_ms = cuda_ms(assemble_and_apply, reps=reps)
            wall, eager = dev_ms / 1e3, eager_ms / 1e3
        else:
            wall = eager = time_call(assemble_and_apply, reps=reps)
        rec = {
            "level": level,
            "n_elems": int(n_e),
            "n_dofs": int(2 * n_n),
            "assemble_apply_s": wall,
            "gdof_per_s": 2 * n_n / wall / 1e9,
            "assemble_apply_eager_s": eager,
        }
        results.append(rec)
        if verbose:
            print(json.dumps(rec), flush=True)
    return results


if __name__ == "__main__":
    run_assembly_sweep(device="cpu" if "--cpu" in sys.argv else None)
