#!/usr/bin/env python3
"""Bits and times of the CSR kernels (K1, K3's CSR kernel) against an
earlier design's, on the card.

Builds every CSR operator that `chip_smoke.py` holds K1 and K3's CSR kernel
on: the tsx P1 G and S at refine levels 0 and 4; the footing tangent
multigrid's G, S and Galerkin value maps at L = 2..5; G, S and their f32
heads at P2, P4 and P4 refine 2.  For three seeds an operator it compares
y of this tree's kernel (`ops/csrc/csr_spmv.cu`) with y of the earlier
sources in DIR (a thread a CSR row: `csr_spmv_f64.cu`, `csr_spmv_f32.cu`
built with `-fmad=false`) by `torch.equal`.  Then it times both kernels in
turns (earlier, this, this, earlier) beside cuSPARSE (`torch.mv` on a
`torch.sparse_csr_tensor`) and the bytes bound, CUDA events over a CUDA
graph of 200 launches, and prints one JSON line (`--out FILE` writes it
too).  It exits 1 if any y differs.

    python tools/csr_bits_vs_parent.py --parent DIR [--out FILE]

DIR holds the earlier sources, for example
`.checkout/fem_elastoplasticity_tpu_torch/ops/csrc` of the parent commit
unpacked with `git archive` into `.checkout/`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
SEEDS = (1, 2, 3)


def operators(torch, device) -> dict:
    """{tag: CsrMatrix} of the operators `chip_smoke.py`'s CSR phases take,
    built by the same entry points."""
    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.ops import assembly as asm
    from fem_elastoplasticity_tpu_torch.ops import assembly_df as adf
    from fem_elastoplasticity_tpu_torch.ops import spmv
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element

    ops = {}
    for level in (0, 4):
        mesh = tsx.tsx_mesh(ElementType.P1, level)
        coords = torch.as_tensor(mesh.coords, dtype=torch.float64, device=device)
        geom = asm.compute_geometry(coords, mesh.elems, volume_element(ElementType.P1))
        ops[f"G_L{level}"], ops[f"S_L{level}"] = spmv.residual_operators(geom, device)
    for level in (2, 3, 4, 5):
        ex = {}
        footing.build_df32(FootingConfig.fast_scale(level, max_trips=1), device=device,
                           extras=ex)
        ops[f"footing_G_L{level}"], ops[f"footing_S_L{level}"] = ex["residual_op"]
        for lv, M in enumerate(ex["tangent"].mhat):
            ops[f"Mhat_L{level}_level{lv + 1}to{lv}"] = M
    for tag, et, refine in (("P2_L0", "P2", 0), ("P4_L0", "P4", 0), ("P4_R2", "P4", 2)):
        ex = {}
        tsx.build_df32(TsxTunnelConfig.fast(etype=ElementType[et], solver="ell",
                                            refine_levels=refine), device=device, extras=ex)
        G, S = ex["residual_op"]
        G32, S32 = adf.f32_heads(G, S)
        ops.update({f"G_{tag}": G, f"S_{tag}": S, f"G32_{tag}": G32, f"S32_{tag}": S32})
    return ops


def earlier_kernels(parent: pathlib.Path):
    """{torch dtype name: launcher(A, x) -> y} of the earlier sources."""
    import torch

    from fem_elastoplasticity_tpu_torch.utils.cuda_build import build_library

    libs = {}
    for dt, name, flags in (("float64", "csr_spmv_f64", ()),
                            ("float32", "csr_spmv_f32", ("-fmad=false",))):
        lib = build_library(parent / f"{name}.cu", f"{name}_earlier", flags)
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6
        fn.restype = ctypes.c_int

        def launch(A, x, fn=fn, name=name):
            y = torch.empty(A.n_rows, dtype=x.dtype, device=x.device)
            err = fn(A.n_rows, A.indptr.data_ptr(), A.indices.data_ptr(), A.values.data_ptr(),
                     x.data_ptr(), y.data_ptr(), torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"{name} (earlier) launch failed: cudaError_t {err}")
            return y

        libs[dt] = launch
    return libs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="directory of the earlier .cu sources")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    if not torch.cuda.is_available():
        print("csr_bits_vs_parent: no CUDA device visible", file=sys.stderr)
        return 2
    from chip_smoke import bound_ms, card_line, cuda_ms
    from fem_elastoplasticity_tpu_torch.ops import spmv

    device = torch.device("cuda")
    card = card_line()
    spmv.load_kernel()
    earlier = earlier_kernels(pathlib.Path(args.parent).resolve())
    records, all_equal = {}, True
    for tag, A in operators(torch, device).items():
        dt = str(A.values.dtype).replace("torch.", "")
        new = spmv.csr_spmv_f64_cuda if dt == "float64" else spmv.csr_spmv_f32_cuda
        old = earlier[dt]
        equal = []
        for seed in SEEDS:
            gen = torch.Generator(device=device).manual_seed(seed)
            x = torch.randn(A.shape[1], generator=gen, dtype=A.values.dtype, device=device)
            equal.append(bool(torch.equal(new(A, x), old(A, x))))
        all_equal &= all(equal)
        A_lib = torch.sparse_csr_tensor(A.indptr, A.indices, A.values, A.shape,
                                        check_invariants=False)
        t_old = [cuda_ms(lambda: old(A, x))[0]]
        t_new = [cuda_ms(lambda: new(A, x))[0] for _ in range(2)]
        t_old.append(cuda_ms(lambda: old(A, x))[0])
        t_lib = cuda_ms(lambda: torch.mv(A_lib, x))[0]
        nnz, vsize = int(A.values.numel()), A.values.element_size()
        n_bytes = (vsize + 4) * nnz + 4 * (A.shape[0] + 1) + vsize * (A.shape[1] + A.shape[0])
        b_ms, _ = bound_ms(n_bytes, 2 * nnz, dt)
        rb = A.row_blocks
        records[tag] = dict(rows=A.shape[0], cols=A.shape[1], nnz=nnz, dtype=dt,
                            bitwise_equal=equal, row_blocks=int(rb.shape[0]) - 1,
                            ms=t_new, earlier_ms=t_old, cusparse_ms=t_lib, bound_ms=b_ms)
        print(f"[bits] {tag} {A.shape[0]}x{A.shape[1]} nnz {nnz} {dt}: equal {equal} | "
              f"row blocks {int(rb.shape[0]) - 1} (E {spmv.ROW_BLOCK_ENTRIES}, T "
              f"{spmv.ROW_BLOCK_ROWS}) | ms: this {t_new[0]:.5f} {t_new[1]:.5f} earlier "
              f"{t_old[0]:.5f} {t_old[1]:.5f} cuSPARSE {t_lib:.5f} bound {b_ms:.5f} | {card}",
              flush=True)
    line = json.dumps({"card": card, "all_equal": all_equal, "seeds": SEEDS,
                       "operators": records})
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
