#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

Drives the port's paths through the entry points a user calls and checks
them against the repository's anchors:

  1. device   — a CUDA card is required; prints its name and power limit
                as `nvidia-smi --query-gpu=name,power.limit` gives them;
  2. build    — builds kernels K1 (ops/csrc/csr_spmv_f64.cu), K2
                (ops/csrc/dp_return_map.cu), K3 (ops/csrc/csr_spmv_f32.cu)
                and K4 (ops/csrc/block_jacobi_sweep.cu) with nvcc, all at
                once;
  3. K1       — the kernel against its plain PyTorch version on the strain
                and force operators G/S of the tsx mesh at refine levels 0
                and 4, seeded inputs, normwise relative difference <= 1e-13;
                CUDA-event times of both, the bytes bound, and cuSPARSE's
                time for the same product (`torch.sparse_csr_tensor @ x`);
  4. K2       — the kernel against its plain version at 896 points (the
                main path's) and 227,072 (tsx refine 4), f32 and f64, with
                and without the plastic-strain update, both apex modes:
                identical branch masks, max abs difference over max |plain|
                <= 1e-6 (f32) / 1e-13 (f64), two launches bit-identical;
                CUDA-event times beside the bytes bound;
  5. f64      — `solve(TsxTunnelConfig())`: 17 steps, 28 Newton iterations,
                u[40,0] within 1e-9 relative of the f64 anchor;
  6. bench    — `TsxTunnelConfig.fast(assembled_cg=True)`: the same gate,
                K1 launched (and the plain version not) during the solve,
                and two runs with identical counts and bit-identical u;
  7. tsx f32  — `solve(TsxTunnelConfig.fast_f32())`: 17 steps, u[40,0]
                within 1e-5 relative of -1.979450e-03, K2 launched and the
                plain version not, two runs with equal counts and
                bit-identical u;
  8. footing f64 — `footing.solve(FootingConfig())`: 16 steps, zeta ending
                at 1.032 (1e-12), the reference's 16 pressures within 1e-4;
  9. footing f32 — `footing.solve(FootingConfig.fast_f32())`: zeta reaches
                1, the limit pressure within 5e-4 of the f64 run's, K2
                launched and the plain version not, two runs with equal
                counts and bit-identical u;
 10. scale L1 — `solve(TsxTunnelConfig.fast_scale(1))`, the multigrid-CG
                preset on the once-refined mesh: 17 steps, u[40,0] within
                1e-8 relative of -2.166787295662e-03, 20 plastic points, K3,
                K4 and K1 launched and no plain version;
 11. K3       — the f32 CSR SpMV against its plain version on the fine
                elastic operator of the level-4 hierarchy (228,112 rows), on
                its P and R, and on the level-1 fine operator, seeded x: max
                abs difference over max |plain| <= 2e-6, two launches
                bit-identical; times, bytes bound and cuSPARSE's time;
 12. K4       — the fused block-Jacobi sweep against its plain version on
                the level-4 and level-1 fine operators, seeded z and r, with
                and without the update: <= 5e-6, exact zeros on constrained
                rows, two launches bit-identical; times and bytes bound;
 13. scale L4 — `build_df32(TsxTunnelConfig.fast_scale(4))` (setup time
                printed), then two runs: 17 steps, u[40,0] within 1e-6
                relative of -2.264312e-3, the step / Newton / CG / plastic
                counts beside the JAX package's recorded 17 / 52 / 605 /
                1,477, equal counts and bit-identical u in both runs, K3, K4
                and K1 launched and no plain version.

Every phase prints its lines with the card line beside its numbers.  Before
the last line it prints a JSON line with the kernel table; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check exits non-zero before that line.

    python3 chip_smoke.py
"""
from __future__ import annotations

import concurrent.futures
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
ANCHOR_U40_F64 = -1.9794499636012143e-03
ANCHOR_U40_F32 = -1.979450e-03  # tests/test_pallas_return_map.py:89
K1_TOL = 1e-13  # normwise relative, kernel vs plain, both f64
K2_TOL = {"float32": 1e-6, "float64": 1e-13}  # max abs diff / max |plain|
K3_TOL = 2e-6  # max abs diff / max |plain|, kernel vs plain, both f32
K4_TOL = 5e-6
ANCHOR_U40_SCALE_L1 = -2.166787295662e-03  # tests/test_tsx_tunnel.py:236
ANCHOR_U40_SCALE_L4 = -2.264312e-3  # BENCH_NOTES.md:436
JAX_COUNTS_SCALE_L4 = (17, 52, 605, 1477)  # steps, Newton, CG, plastic (BENCH_NOTES.md:124)
SEED = 20261016
# NVIDIA H100 SXM data sheet: HBM3 rate, and the f32 / f64 rates outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
K2_FLOPS_PER_POINT = 150
# tests/test_footing.py: the reference's pressure curve, P1 level 1
FOOTING_PRESSURES = (
    8.39724807, 13.20017031, 15.73188141, 16.14965303, 16.27589772,
    16.3163306, 16.38698285, 16.5422787, 16.62435145, 16.69057978,
    16.77442565, 16.83580515, 16.85149363, 16.84581189, 16.83867399,
    16.83636362,
)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 200):
    """Mean milliseconds per call of `fn`, from CUDA events:
    (device, eager).  `device` replays the calls captured in a CUDA graph,
    so host launch overhead drops out; `eager` launches them back to back
    from Python, as the solver does, and includes that overhead."""
    for _ in range(5):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    eager = start.elapsed_time(end) / reps
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, eager


def bound_ms(n_bytes: float, flops: float, dtype: str):
    """(least time in ms, what sets it) for moving `n_bytes` once and doing
    `flops` at the card's published peaks."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def check_solve(tag: str, r, n_steps=17, n_newton=28) -> float:
    import numpy as np

    check(r.u.shape == (476, 2) and r.ep.shape == (4, 896),
          f"{tag}: shapes {r.u.shape} {r.ep.shape}")
    check(bool(np.isfinite(r.u).all() and np.isfinite(r.ep).all()), f"{tag}: non-finite field")
    u40 = float(r.u[40, 0])
    rel = abs(u40 - ANCHOR_U40_F64) / abs(ANCHOR_U40_F64)
    check(r.n_steps == n_steps and r.n_newton_total == n_newton,
          f"{tag}: {r.n_steps} steps / {r.n_newton_total} Newton iterations")
    check(rel <= 1e-9, f"{tag}: u40 {u40!r} is {rel:.3e} from the anchor")
    return rel


def timed(torch, fn):
    """(result, host wall in s) of fn() ending in a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def k1_phase(torch, spmv, tsx, asm, ElementType, volume_element, device, card):
    gen = torch.Generator(device=device).manual_seed(SEED)
    shapes, max_err = {}, 0.0
    for level in (0, 4):
        mesh = tsx.tsx_mesh(ElementType.P1, level)
        coords = torch.as_tensor(mesh.coords, dtype=torch.float64, device=device)
        geom = asm.compute_geometry(coords, mesh.elems, volume_element(ElementType.P1))
        G, S = spmv.build_residual_csr(
            geom.B.cpu().numpy(), geom.weight.cpu().numpy(), geom.edofs.cpu().numpy(),
            geom.n_q, geom.n_nodes,
        )
        for name, A in (("G", spmv.csr_to_device(G, device)), ("S", spmv.csr_to_device(S, device))):
            x = torch.randn(A.shape[1], generator=gen, dtype=torch.float64, device=device)
            y = spmv.csr_spmv_f64_cuda(A, x)
            y_plain = spmv.csr_matvec_plain(A, x)
            torch.cuda.synchronize()
            err = float((y - y_plain).abs().max())
            rel = float(torch.linalg.norm(y - y_plain) / torch.linalg.norm(y_plain))
            check(rel <= K1_TOL, f"K1 {name} L{level}: relative difference {rel:.3e}")
            check(torch.equal(y, spmv.csr_spmv_f64_cuda(A, x)),
                  f"K1 {name} L{level}: not bitwise repeatable")
            # the yardstick: one PyTorch call (cuSPARSE) for the same product
            A_lib = torch.sparse_csr_tensor(
                A.indptr, A.indices, A.values, A.shape, check_invariants=False)
            y_lib = torch.mv(A_lib, x)
            torch.cuda.synchronize()
            lib_rel = float(torch.linalg.norm(y_lib - y_plain) / torch.linalg.norm(y_plain))
            check(lib_rel <= K1_TOL, f"K1 {name} L{level}: cuSPARSE differs by {lib_rel:.3e}")
            ms, eager_ms = cuda_ms(torch, lambda: spmv.csr_spmv_f64_cuda(A, x))
            plain_ms, plain_eager_ms = cuda_ms(torch, lambda: spmv.csr_matvec_plain(A, x))
            lib_ms, lib_eager_ms = cuda_ms(torch, lambda: torch.mv(A_lib, x))
            nnz = int(A.values.numel())
            n_bytes = 12 * nnz + 4 * (A.shape[0] + 1) + 8 * A.shape[1] + 8 * A.shape[0]
            b_ms, b_by = bound_ms(n_bytes, 2 * nnz, "float64")
            max_err = max(max_err, err)
            shapes[f"{name}_L{level}"] = dict(
                rows=A.shape[0], cols=A.shape[1], nnz=nnz,
                rel=rel, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                eager_ms=eager_ms, plain_eager_ms=plain_eager_ms,
                library_eager_ms=lib_eager_ms, bytes=n_bytes, bound_ms=b_ms, bound_by=b_by,
            )
            say("K1", f"{name} L{level} {A.shape[0]}x{A.shape[1]} nnz {nnz}: "
                f"rel {rel:.3e} max_abs {err:.3e} | device: kernel {ms:.5f} ms plain "
                f"{plain_ms:.5f} ms cuSPARSE {lib_ms:.5f} ms bound {b_ms:.5f} ms ({b_by}) | "
                f"eager: kernel {eager_ms:.5f} ms plain {plain_eager_ms:.5f} ms "
                f"cuSPARSE {lib_eager_ms:.5f} ms | {card}")
    return shapes, max_err


def k2_phase(torch, rm, device, card):
    import numpy as np

    from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.models.materials import drucker_prager_fit, lame_moduli

    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    shapes, max_err, bitwise = {}, 0.0, True
    for n in (896, 887 * 4**4):  # the main path's points; tsx refine 4
        rng = np.random.default_rng(SEED + n)
        e3_np = rng.normal(0, 2e-3, (3, n))
        ep_np = rng.normal(0, 2e-4, (4, n))
        e0_np = rng.normal(0, 1e-3, 4)
        for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            e3 = torch.as_tensor(e3_np, dtype=dt, device=device)
            ep = torch.as_tensor(ep_np, dtype=dt, device=device)
            e0 = torch.as_tensor(e0_np, dtype=dt, device=device)
            params = rm.make_params(eta, c, e0, dt, device)
            for apply in (False, True):
                for apex in (False, True):
                    if apex and not apply:
                        continue  # the apex mode only changes the plastic-strain update
                    args = (e3, ep, params, shear, bulk, apply, apex)
                    got = rm.dp_return_map_cuda(*args)
                    exp = rm.dp_return_map_plain(*args)
                    again = rm.dp_return_map_cuda(*args)
                    torch.cuda.synchronize()
                    tag = f"n{n}_{dt_name}_{'ep' if apply else 'noep'}{'_trial' if apex else ''}"
                    lam_k, lam_p = got[2], exp[2]
                    apex_k = (lam_k > 0) & (got[1] == 0).all(dim=0)
                    apex_p = (lam_p > 0) & (exp[1] == 0).all(dim=0)
                    n_plastic, n_apex = int((lam_p > 0).sum()), int(apex_p.sum())
                    check(0 < n_apex < n_plastic < n, f"K2 {tag}: branches not all hit "
                          f"({n_plastic} plastic, {n_apex} apex of {n})")
                    check(torch.equal(lam_k > 0, lam_p > 0) and torch.equal(apex_k, apex_p),
                          f"K2 {tag}: branch masks differ")
                    rels = []
                    for g, x in zip(got, exp):
                        err = float((g - x).abs().max())
                        rels.append(err / float(x.abs().max()))
                        max_err = max(max_err, err)
                    check(max(rels) <= K2_TOL[dt_name], f"K2 {tag}: relative difference {max(rels):.3e}")
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"K2 {tag}: two launches differ")
                    same = all(torch.equal(a, b) for a, b in zip(got, exp))
                    bitwise = bitwise and same
                    ms, eager_ms = cuda_ms(torch, lambda: rm.dp_return_map_cuda(*args), reps=100)
                    plain_ms, plain_eager_ms = cuda_ms(
                        torch, lambda: rm.dp_return_map_plain(*args), reps=100)
                    size = 4 if dt == torch.float32 else 8
                    b_ms, b_by = bound_ms(22 * size * n, K2_FLOPS_PER_POINT * n, dt_name)
                    shapes[tag] = dict(
                        n=n, dtype=dt_name, apply_plastic_strain=apply, apex_ep_uses_trial=apex,
                        n_plastic=n_plastic, n_apex=n_apex, rel=max(rels), bitwise_equal=same,
                        ms=ms, plain_ms=plain_ms, eager_ms=eager_ms, plain_eager_ms=plain_eager_ms,
                        bytes=22 * size * n, bound_ms=b_ms, bound_by=b_by,
                    )
                    say("K2", f"{tag}: {n_plastic} plastic / {n_apex} apex, rel {max(rels):.3e}, "
                        f"bitwise {same} | device: kernel {ms:.5f} ms plain {plain_ms:.5f} ms "
                        f"bound {b_ms:.5f} ms ({b_by}) | eager: kernel {eager_ms:.5f} ms "
                        f"plain {plain_eager_ms:.5f} ms | {card}")
    return shapes, max_err, bitwise


def k3_phase(torch, spmv, ops, device, card):
    """ops: {tag: CsrMatrix (f32)} -> per-operator records."""
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    shapes, max_err = {}, 0.0
    for tag, A in ops.items():
        x = torch.as_tensor(rng.standard_normal(A.shape[1]).astype(np.float32), device=device)
        y = spmv.csr_spmv_f32_cuda(A, x)
        y_plain = spmv.csr_matvec_plain(A, x)
        torch.cuda.synchronize()
        err = float((y - y_plain).abs().max())
        rel = err / float(y_plain.abs().max())
        check(rel <= K3_TOL, f"K3 {tag}: relative difference {rel:.3e}")
        check(torch.equal(y, spmv.csr_spmv_f32_cuda(A, x)), f"K3 {tag}: not bitwise repeatable")
        # the yardstick: one PyTorch call (cuSPARSE) for the same product
        A_lib = torch.sparse_csr_tensor(
            A.indptr, A.indices, A.values, A.shape, check_invariants=False)
        y_lib = torch.mv(A_lib, x)
        torch.cuda.synchronize()
        lib_rel = float((y_lib - y_plain).abs().max() / y_plain.abs().max())
        check(lib_rel <= K3_TOL, f"K3 {tag}: cuSPARSE differs by {lib_rel:.3e}")
        ms, eager_ms = cuda_ms(torch, lambda: spmv.csr_spmv_f32_cuda(A, x))
        plain_ms, plain_eager_ms = cuda_ms(torch, lambda: spmv.csr_matvec_plain(A, x))
        lib_ms, lib_eager_ms = cuda_ms(torch, lambda: torch.mv(A_lib, x))
        nnz = int(A.values.numel())
        n_bytes = 8 * nnz + 4 * (A.shape[0] + 1) + 4 * A.shape[1] + 4 * A.shape[0]
        b_ms, b_by = bound_ms(n_bytes, 2 * nnz, "float32")
        max_err = max(max_err, err)
        shapes[tag] = dict(
            rows=A.shape[0], cols=A.shape[1], nnz=nnz, rel=rel, max_abs_err=err,
            ms=ms, plain_ms=plain_ms, library_ms=lib_ms, eager_ms=eager_ms,
            plain_eager_ms=plain_eager_ms, library_eager_ms=lib_eager_ms,
            bytes=n_bytes, bound_ms=b_ms, bound_by=b_by,
        )
        say("K3", f"{tag} {A.shape[0]}x{A.shape[1]} nnz {nnz}: rel {rel:.3e} max_abs {err:.3e} | "
            f"device: kernel {ms:.5f} ms plain {plain_ms:.5f} ms cuSPARSE {lib_ms:.5f} ms "
            f"bound {b_ms:.5f} ms ({b_by}) | eager: kernel {eager_ms:.5f} ms plain "
            f"{plain_eager_ms:.5f} ms cuSPARSE {lib_eager_ms:.5f} ms | {card}")
    return shapes, max_err


def k4_phase(torch, spmv, levels, device, card):
    """levels: {tag: MGLevel} -> per-case records."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    shapes, max_err = {}, 0.0
    for tag, lev in levels.items():
        A, aux = lev.op, lev.aux
        n = A.shape[0]
        z = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
        r = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
        # on a like scale: A z is of the stiffness's size
        r = r * spmv.csr_matvec_plain(A, z).abs().max()
        n_fixed = int((aux.mask == 0).sum())
        check(n_fixed > 0, f"K4 {tag}: no constrained row in the operator")
        for update in (True, False):
            case = f"{tag}_{'update' if update else 'residual'}"
            got = spmv.block_jacobi_sweep_cuda(A, aux, z, r, update)
            exp = spmv.block_jacobi_sweep_plain(A, aux, z, r, update)
            torch.cuda.synchronize()
            err = float((got - exp).abs().max())
            rel = err / float(exp.abs().max())
            check(rel <= K4_TOL, f"K4 {case}: relative difference {rel:.3e}")
            fixed = got[aux.mask == 0]
            want = z[aux.mask == 0] if update else torch.zeros_like(fixed)
            check(torch.equal(fixed, want), f"K4 {case}: constrained rows moved")
            check(torch.equal(got, spmv.block_jacobi_sweep_cuda(A, aux, z, r, update)),
                  f"K4 {case}: not bitwise repeatable")
            ms, eager_ms = cuda_ms(
                torch, lambda: spmv.block_jacobi_sweep_cuda(A, aux, z, r, update))
            plain_ms, plain_eager_ms = cuda_ms(
                torch, lambda: spmv.block_jacobi_sweep_plain(A, aux, z, r, update))
            nnz = int(A.values.numel())
            # operator, then z, r, mask (and msf, mpr with the update) in, out written
            n_bytes = 8 * nnz + 4 * (n + 1) + 4 * n * (6 if update else 4)
            b_ms, b_by = bound_ms(n_bytes, 2 * nnz + (8 if update else 2) * n, "float32")
            max_err = max(max_err, err)
            shapes[case] = dict(
                rows=n, nnz=nnz, constrained_rows=n_fixed, update=update, rel=rel,
                max_abs_err=err, ms=ms, plain_ms=plain_ms, eager_ms=eager_ms,
                plain_eager_ms=plain_eager_ms, bytes=n_bytes, bound_ms=b_ms, bound_by=b_by,
            )
            say("K4", f"{case} {n} rows nnz {nnz}: rel {rel:.3e} max_abs {err:.3e}, "
                f"{n_fixed} constrained rows exact | device: kernel {ms:.5f} ms plain "
                f"{plain_ms:.5f} ms bound {b_ms:.5f} ms ({b_by}) | eager: kernel "
                f"{eager_ms:.5f} ms plain {plain_eager_ms:.5f} ms | {card}")
    return shapes, max_err


SCALE_KERNELS = ("csr_spmv_f32", "block_jacobi_sweep", "csr_spmv_f64")


def check_scale_launches(tag: str, launches: dict) -> None:
    for name in SCALE_KERNELS:
        check(launches.get(name, 0) > 0, f"{tag}: {name} never launched ({launches})")
    plain = {k: v for k, v in launches.items() if k.endswith("_plain") and v}
    check(not plain, f"{tag}: a plain version ran on the card ({plain})")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.ops import assembly as asm
    from fem_elastoplasticity_tpu_torch.ops import return_map as rm
    from fem_elastoplasticity_tpu_torch.ops import spmv
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element
    from fem_elastoplasticity_tpu_torch.utils.precision import resolve_device

    device = resolve_device("cuda")
    kind = torch.cuda.get_device_name(device)
    card = card_line()
    print(card, flush=True)  # phase 1: the card, as nvidia-smi gives it

    # phase 2: one nvcc per source, started together
    def build(load):
        t0 = time.perf_counter()
        load()
        return time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        futs = {name: pool.submit(build, load) for name, load in (
            ("csr_spmv_f64", spmv.load_kernel), ("dp_return_map", rm.load_kernel),
            ("csr_spmv_f32", spmv.load_kernel_f32),
            ("block_jacobi_sweep", spmv.load_sweep_kernel))}
        build_s = {name: f.result() for name, f in futs.items()}
    say("build", f"csr_spmv_f64 {build_s['csr_spmv_f64']:.2f} s, dp_return_map (-fmad=false) "
        f"{build_s['dp_return_map']:.2f} s, csr_spmv_f32 (-fmad=false) "
        f"{build_s['csr_spmv_f32']:.2f} s, block_jacobi_sweep (-fmad=false) "
        f"{build_s['block_jacobi_sweep']:.2f} s, in parallel "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")

    k1_shapes, k1_err = k1_phase(torch, spmv, tsx, asm, ElementType, volume_element, device, card)
    k2_shapes, k2_err, k2_bitwise = k2_phase(torch, rm, device, card)
    say("K2", f"kernel and plain version bitwise equal in every case: {k2_bitwise} | {card}")

    r64, wall64 = timed(torch, lambda: tsx.solve(TsxTunnelConfig(), device=device))
    rel64 = check_solve("f64", r64)
    say("f64", f"17 steps / 28 its, u40 rel {rel64:.3e}, wall {wall64:.3f} s (first call) | {card}")

    cfg = TsxTunnelConfig.fast(assembled_cg=True)
    run, _ = tsx.build_df32(cfg, device=device)
    spmv.LAUNCHES.clear()
    rm.LAUNCHES.clear()
    res1, wall_first = timed(torch, run)
    launches = dict(spmv.LAUNCHES)
    res2, wall_warm = timed(torch, run)
    r1, r2 = tsx._df32_result(res1, None), tsx._df32_result(res2, None)
    rel_df = check_solve("bench", r1)
    check(launches.get("csr_spmv_f64", 0) > 0, f"bench: K1 never launched ({launches})")
    check(launches.get("csr_spmv_f64_plain", 0) == 0,
          f"bench: plain SpMV ran on the card ({launches})")
    counts = lambda r: (r.n_steps, r.n_newton_total, r.n_plastic)  # noqa: E731
    check(counts(r1) == counts(r2),
          "bench: two runs differ in their counts")
    check(torch.equal(res1.u, res2.u), "bench: two runs differ in u")
    field = float(abs(r1.u - r64.u).max() / abs(r64.u).max())
    check(field < 1e-11, f"bench: field differs from the f64 solve by {field:.3e}")
    say("bench", f"17 steps / 28 its, u40 rel {rel_df:.3e}, field vs f64 {field:.3e}, "
        f"K1 launches {launches.get('csr_spmv_f64', 0)}, "
        f"plain {launches.get('csr_spmv_f64_plain', 0)}, "
        f"repeat bit-identical, wall first {wall_first:.4f} s warm {wall_warm:.4f} s | {card}")

    # phase 7: tsx f32 through K2
    rm.LAUNCHES.clear()
    t1, t_first = timed(torch, lambda: tsx.solve(TsxTunnelConfig.fast_f32(), device=device))
    k2_tsx = dict(rm.LAUNCHES)
    t2, t_warm = timed(torch, lambda: tsx.solve(TsxTunnelConfig.fast_f32(), device=device))
    check(k2_tsx.get("dp_return_map", 0) > 0, f"tsx f32: K2 never launched ({k2_tsx})")
    check(k2_tsx.get("dp_return_map_plain", 0) == 0, f"tsx f32: plain return map ran ({k2_tsx})")
    check(bool(np.isfinite(t1.u).all()) and t1.u.shape == (476, 2), "tsx f32: bad field")
    check(t1.n_steps == 17, f"tsx f32: {t1.n_steps} steps")
    u40_rel = abs(float(t1.u[40, 0]) - ANCHOR_U40_F32) / abs(ANCHOR_U40_F32)
    check(u40_rel <= 1e-5, f"tsx f32: u40 {float(t1.u[40, 0])!r} is {u40_rel:.3e} from the anchor")
    check(counts(t1) == counts(t2), "tsx f32: two runs differ in their counts")
    check(np.array_equal(t1.u, t2.u), "tsx f32: two runs differ in u")
    f32_vs_f64 = abs(float(t1.u[40, 0]) - ANCHOR_U40_F64) / abs(ANCHOR_U40_F64)
    say("tsx f32", f"{t1.n_steps} steps / {t1.n_newton_total} its / {t1.n_plastic} plastic, "
        f"u40 {t1.u[40, 0]:.9e} (rel {u40_rel:.3e} to -1.979450e-03, {f32_vs_f64:.3e} to the "
        f"f64 anchor), K2 launches {k2_tsx.get('dp_return_map', 0)}, plain "
        f"{k2_tsx.get('dp_return_map_plain', 0)}, repeat bit-identical, wall first "
        f"{t_first:.4f} s warm {t_warm:.4f} s | {card}")

    # phase 8: footing f64, the parity anchor of the f32 run
    f1, f_first = timed(torch, lambda: footing.solve(FootingConfig(), device=device))
    _, f_warm = timed(torch, lambda: footing.solve(FootingConfig(), device=device))
    check(bool(np.isfinite(f1.u).all()) and f1.u.shape == (441, 2), "footing f64: bad field")
    check(f1.n_steps == 16, f"footing f64: {f1.n_steps} steps")
    check(abs(f1.zeta_hist[16] - 1.032) <= 1e-12, f"footing f64: zeta ends at {float(f1.zeta_hist[16])!r}")
    ref = np.asarray(FOOTING_PRESSURES)
    p_rel = float(np.abs(f1.pressure_hist[1:17] - ref).max() / ref.max())
    check(p_rel <= 1e-4, f"footing f64: pressures {p_rel:.3e} from the reference")
    say("footing f64", f"{f1.n_steps} steps / {f1.n_newton_total} its / {f1.n_plastic} plastic, "
        f"zeta {float(f1.zeta_hist[16])!r}, pressures rel {p_rel:.3e} to the reference, limit pressure "
        f"{float(f1.pressure_hist[16])!r}, wall first {f_first:.4f} s warm {f_warm:.4f} s | {card}")

    # phase 9: footing f32 through K2
    rm.LAUNCHES.clear()
    g1, g_first = timed(torch, lambda: footing.solve(FootingConfig.fast_f32(), device=device))
    k2_foot = dict(rm.LAUNCHES)
    g2, g_warm = timed(torch, lambda: footing.solve(FootingConfig.fast_f32(), device=device))
    check(k2_foot.get("dp_return_map", 0) > 0, f"footing f32: K2 never launched ({k2_foot})")
    check(k2_foot.get("dp_return_map_plain", 0) == 0,
          f"footing f32: plain return map ran ({k2_foot})")
    check(bool(np.isfinite(g1.u).all()) and g1.u.shape == (441, 2), "footing f32: bad field")
    check(g1.zeta_hist[g1.n_steps] >= 1.0, f"footing f32: zeta ends at {float(g1.zeta_hist[g1.n_steps])!r}")
    p32, p64 = float(g1.pressure_hist[g1.n_steps]), float(f1.pressure_hist[16])
    lim_rel = abs(p32 - p64) / p64
    check(lim_rel <= 5e-4, f"footing f32: limit pressure {p32!r} is {lim_rel:.3e} from f64")
    check(counts(g1) == counts(g2), "footing f32: two runs differ in their counts")
    check(np.array_equal(g1.u, g2.u), "footing f32: two runs differ in u")
    say("footing f32", f"{g1.n_steps} steps / {g1.n_newton_total} its / {g1.n_plastic} plastic, "
        f"zeta {float(g1.zeta_hist[g1.n_steps])!r}, limit pressure {p32!r} (rel {lim_rel:.3e} to f64), "
        f"K2 launches {k2_foot.get('dp_return_map', 0)}, plain "
        f"{k2_foot.get('dp_return_map_plain', 0)}, repeat bit-identical, "
        f"wall first {g_first:.4f} s warm {g_warm:.4f} s | {card}")

    # phase 10: the scale preset on the once-refined mesh, through solve()
    spmv.LAUNCHES.clear()
    s1, s1_wall = timed(torch, lambda: tsx.solve(TsxTunnelConfig.fast_scale(1), device=device))
    l1_launches = dict(spmv.LAUNCHES)
    check(s1.u.shape == (1839, 2) and bool(np.isfinite(s1.u).all()), "scale L1: bad field")
    check(s1.n_steps == 17, f"scale L1: {s1.n_steps} steps")
    l1_rel = abs(float(s1.u[40, 0]) - ANCHOR_U40_SCALE_L1) / abs(ANCHOR_U40_SCALE_L1)
    check(l1_rel <= 1e-8, f"scale L1: u40 {float(s1.u[40, 0])!r} is {l1_rel:.3e} from the anchor")
    check(s1.n_plastic == 20, f"scale L1: {s1.n_plastic} plastic points")
    check_scale_launches("scale L1", l1_launches)
    say("scale L1", f"{s1.n_steps} steps / {s1.n_newton_total} its / {s1.n_cg_total} CG / "
        f"{s1.n_plastic} plastic, u40 {s1.u[40, 0]:.12e} (rel {l1_rel:.3e}), launches "
        f"{l1_launches}, wall {s1_wall:.3f} s (setup included) | {card}")

    # phases 11-13: level 4, the full width of the scale path
    ex1, ex4 = {}, {}
    tsx.build_df32(TsxTunnelConfig.fast_scale(1), device=device, extras=ex1)
    t0 = time.perf_counter()
    run4, mesh4 = tsx.build_df32(TsxTunnelConfig.fast_scale(4), device=device, extras=ex4)
    torch.cuda.synchronize()
    setup4 = time.perf_counter() - t0
    fine4, fine1 = ex4["hierarchy"].levels[-1], ex1["hierarchy"].levels[-1]
    sizes = [lev.op.shape[0] for lev in ex4["hierarchy"].levels]
    say("scale L4", f"setup {setup4:.2f} s (host: hierarchy, G/S, refresh table); "
        f"{mesh4.n_nodes} nodes, {mesh4.n_elems} elements, hierarchy rows {sizes} | {card}")
    k3_shapes, k3_err = k3_phase(
        torch, spmv, {"K_L4": fine4.op, "P_L4": fine4.P, "R_L4": fine4.R, "K_L1": fine1.op},
        device, card)
    k4_shapes, k4_err = k4_phase(torch, spmv, {"L4": fine4, "L1": fine1}, device, card)

    spmv.LAUNCHES.clear()
    q1, q_first = timed(torch, run4)
    l4_launches = dict(spmv.LAUNCHES)
    q2, q_warm = timed(torch, run4)
    a1, a2 = tsx._df32_result(q1, mesh4, ex4), tsx._df32_result(q2, mesh4, ex4)
    check(a1.u.shape == (114056, 2) and a1.ep.shape == (4, 227072),
          f"scale L4: shapes {a1.u.shape} {a1.ep.shape}")
    check(bool(np.isfinite(a1.u).all() and np.isfinite(a1.ep).all()), "scale L4: non-finite field")
    check(a1.n_steps == 17, f"scale L4: {a1.n_steps} steps")
    l4_rel = abs(float(a1.u[40, 0]) - ANCHOR_U40_SCALE_L4) / abs(ANCHOR_U40_SCALE_L4)
    check(l4_rel <= 1e-6, f"scale L4: u40 {float(a1.u[40, 0])!r} is {l4_rel:.3e} from the anchor")
    counts4 = lambda r: (r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic)  # noqa: E731
    check(counts4(a1) == counts4(a2), "scale L4: two runs differ in their counts")
    check(torch.equal(q1.u, q2.u), "scale L4: two runs differ in u")
    check_scale_launches("scale L4", l4_launches)
    say("scale L4", f"steps / Newton / CG / plastic {counts4(a1)} (JAX package's record "
        f"{JAX_COUNTS_SCALE_L4}), u40 {a1.u[40, 0]:.9e} (rel {l4_rel:.3e} to "
        f"{ANCHOR_U40_SCALE_L4}), launches {l4_launches}, repeat bit-identical, "
        f"wall first {q_first:.3f} s warm {q_warm:.3f} s | {card}")

    l0 = ("G_L0", "S_L0")
    main_k2 = k2_shapes["n896_float32_noep"]  # one Newton-iteration call of the f32 paths
    print(json.dumps({"card": card, "kernels": [{
        "name": "csr_spmv_f64",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/csr_spmv_f64.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1370",
        "launches": launches.get("csr_spmv_f64", 0) + l1_launches["csr_spmv_f64"]
        + l4_launches["csr_spmv_f64"],
        "launches_by_path": {"bench": launches.get("csr_spmv_f64", 0),
                             "scale_L1": l1_launches["csr_spmv_f64"],
                             "scale_L4": l4_launches["csr_spmv_f64"]},
        "max_abs_err": k1_err,
        # one residual evaluation of the main path: G u then S s, level 0
        "ms": sum(k1_shapes[k]["ms"] for k in l0),
        "plain_ms": sum(k1_shapes[k]["plain_ms"] for k in l0),
        "bound_ms": sum(k1_shapes[k]["bound_ms"] for k in l0),
        "bound_by": "bytes",
        "library_ms": sum(k1_shapes[k]["library_ms"] for k in l0),
        "shapes": k1_shapes,
    }, {
        "name": "dp_return_map",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/dp_return_map.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/return_map_pallas.py:160",
        "launches": k2_tsx.get("dp_return_map", 0) + k2_foot.get("dp_return_map", 0),
        "launches_by_path": {"tsx_f32": k2_tsx.get("dp_return_map", 0),
                             "footing_f32": k2_foot.get("dp_return_map", 0)},
        "max_abs_err": k2_err,
        "ms": main_k2["ms"],
        "plain_ms": main_k2["plain_ms"],
        "bound_ms": main_k2["bound_ms"],
        "bound_by": main_k2["bound_by"],
        # no single PyTorch call computes the return map
        "library_ms": None,
        "bitwise_equal_to_plain": k2_bitwise,
        "shapes": k2_shapes,
    }, {
        "name": "csr_spmv_f32",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/csr_spmv_f32.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1431",
        "launches": l1_launches["csr_spmv_f32"] + l4_launches["csr_spmv_f32"],
        "launches_by_path": {"scale_L1": l1_launches["csr_spmv_f32"],
                             "scale_L4": l4_launches["csr_spmv_f32"]},
        "max_abs_err": k3_err,
        # the CG operator of the level-4 solve
        "ms": k3_shapes["K_L4"]["ms"],
        "plain_ms": k3_shapes["K_L4"]["plain_ms"],
        "bound_ms": k3_shapes["K_L4"]["bound_ms"],
        "bound_by": k3_shapes["K_L4"]["bound_by"],
        "library_ms": k3_shapes["K_L4"]["library_ms"],
        "shapes": k3_shapes,
    }, {
        "name": "block_jacobi_sweep",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/block_jacobi_sweep.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1610",
        "launches": l1_launches["block_jacobi_sweep"] + l4_launches["block_jacobi_sweep"],
        "launches_by_path": {"scale_L1": l1_launches["block_jacobi_sweep"],
                             "scale_L4": l4_launches["block_jacobi_sweep"]},
        "max_abs_err": k4_err,
        # one smoother sweep on the fine level of the level-4 solve
        "ms": k4_shapes["L4_update"]["ms"],
        "plain_ms": k4_shapes["L4_update"]["plain_ms"],
        "bound_ms": k4_shapes["L4_update"]["bound_ms"],
        "bound_by": k4_shapes["L4_update"]["bound_by"],
        # no single PyTorch call computes the sweep: a sparse product plus
        # the masked 2x2 block update
        "library_ms": None,
        "shapes": k4_shapes,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
