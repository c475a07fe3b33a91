#!/usr/bin/env python3
"""K2 and K7's solve on the card against an earlier design's, in one process.

K2: this tree's one launch (`dp_return_map_cuda`: s, D, ind_p, lam, ep)
against the earlier kernel in DIR (`dp_return_map.cu`: s, ds6, lam, ep)
followed by what the Newton loop then ran, `unpack_tangent(ds6)` and
`lam > 0`, at 896 and 227,072 points, f32 and f64, every mode: the outputs
compared by `torch.equal`, then timed in turns (earlier, this, this,
earlier): the earlier kernel alone and with its unpack and compare, this
kernel, and one PyTorch elementwise kernel on the same number of values.

K7's solve: on the factor of this tree's `cholesky_factor` for the matrices
`chip_smoke.py` phase 5 takes (seeded SPD at n = 128, 200, 908, 2000, the
Jacobi-scaled tsx K_free at 908, the footing's f32 K_free at 816), the
earlier one-block solve in DIR against this tree's cooperative one: the
gap between the two and to the f64 solve, and the times in turns beside
cuSOLVER's `cholesky_solve`.  CUDA events over a CUDA graph of the launches
(`utils.timing.cuda_ms`).  Prints one line a case and one JSON line (`--out
FILE` writes it too); exits 1 if a K2 output differs.

    python tools/k2_k7_vs_parent.py --parent DIR [--out FILE]

DIR holds the earlier sources, for example
`.checkout/parent/fem_elastoplasticity_tpu_torch/ops/csrc` of the parent
commit unpacked with `git archive`.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def earlier_params(eta, c, e0, dtype, device):
    """The earlier K2's runtime parameters, (8,) on the card: [e0_0..e0_3,
    eta, c, 0, 0]."""
    import torch

    tail = torch.tensor([eta, c, 0.0, 0.0], dtype=dtype, device=device)
    return torch.cat([e0.reshape(4).to(dtype), tail])


def earlier_k2(parent: pathlib.Path):
    """launcher(e3, ep, params, shear, bulk, apply, apex) -> (s, ds6, lam,
    ep) of the earlier K2 (constants: 9 doubles, params (8,) on the card,
    `earlier_params`)."""
    import torch

    from fem_elastoplasticity_tpu_torch.ops import return_map as rm
    from fem_elastoplasticity_tpu_torch.utils.cuda_build import build_library

    lib = build_library(parent / "dp_return_map.cu", "dp_return_map_earlier", rm.KERNEL_FLAGS)
    fns = {torch.float32: lib.dp_return_map_f32, torch.float64: lib.dp_return_map_f64}
    for fn in fns.values():
        fn.argtypes = [ctypes.c_longlong, ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 9
        fn.restype = ctypes.c_int

    def launch(e3, ep, params, shear, bulk, apply, apex):
        n = e3.shape[-1]
        s = torch.empty((4, n), dtype=e3.dtype, device=e3.device)
        ds6 = torch.empty((6, n), dtype=e3.dtype, device=e3.device)
        lam = torch.empty((n,), dtype=e3.dtype, device=e3.device)
        ep_out = torch.empty((4, n), dtype=e3.dtype, device=e3.device)
        consts = (ctypes.c_double * 9)(*rm._material_constants(shear, bulk))
        err = fns[e3.dtype](n, int(apply), int(apex), consts, params.data_ptr(), e3.data_ptr(),
                            ep.data_ptr(), s.data_ptr(), ds6.data_ptr(), lam.data_ptr(),
                            ep_out.data_ptr(), torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"dp_return_map (earlier) launch failed: cudaError_t {err}")
        return s, ds6, lam, ep_out

    return launch


def earlier_solve(parent: pathlib.Path):
    """launcher(L, inv, b, n) -> x of the earlier one-block solve."""
    import torch

    from fem_elastoplasticity_tpu_torch.utils.cuda_build import build_library

    lib = build_library(parent / "cholesky_blocked.cu", "cholesky_blocked_earlier")
    fn = lib.cholesky_solve_f32
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
    fn.restype = ctypes.c_int

    def launch(L, inv, b, n):
        x = torch.empty(n, dtype=torch.float32, device=L.device)
        err = fn(n, L.shape[0], L.data_ptr(), inv.data_ptr(), b.data_ptr(), x.data_ptr(),
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"cholesky_solve (earlier) launch failed: cudaError_t {err}")
        return x

    return launch


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True, help="directory of the earlier .cu sources")
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("k2_k7_vs_parent: no CUDA device visible", file=sys.stderr)
        return 2
    from chip_smoke import SEED, card_line, cuda_ms, k7_matrices
    from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.models.materials import drucker_prager_fit, lame_moduli
    from fem_elastoplasticity_tpu_torch.ops import cholesky as chol
    from fem_elastoplasticity_tpu_torch.ops import return_map as rm

    device = torch.device("cuda")
    card = card_line()
    parent = pathlib.Path(args.parent).resolve()
    rm.load_kernel()
    chol.load_kernel()
    old_k2, old_solve = earlier_k2(parent), earlier_solve(parent)

    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    zeta = float(np.float32(7 / 17))
    k2, all_equal = {}, True
    for n in (896, 887 * 4**4):
        rng = np.random.default_rng(SEED + n)
        e3_np, ep_np, e0_np = (rng.normal(0, 2e-3, (3, n)), rng.normal(0, 2e-4, (4, n)),
                               rng.normal(0, 1e-3, 4))
        xf = torch.ones(n, dtype=torch.float32, device=device)
        yf = torch.empty_like(xf)
        for dt in (torch.float32, torch.float64):
            e3, ep, e0_dir = (torch.as_tensor(a, dtype=dt, device=device)
                              for a in (e3_np, ep_np, e0_np))
            for apply, apex in ((False, False), (True, False), (True, True)):
                new_args = (e3, ep, shear, bulk, eta, c, e0_dir, zeta, apply, apex)

                def old_path():  # the parent's Newton loop: e0, params, K2, unpack, mask
                    params = earlier_params(eta, c, e0_dir * zeta, dt, device)
                    s, ds6, lam, ep_ = old_k2(e3, ep, params, shear, bulk, apply, apex)
                    return s, rm.unpack_tangent(ds6), lam > 0.0, lam, ep_

                params = earlier_params(eta, c, e0_dir * zeta, dt, device)
                got, want = rm.dp_return_map_cuda(*new_args), old_path()
                equal = all(torch.equal(g, w) for g, w in zip(got, want))
                all_equal &= equal
                t_old = [cuda_ms(lambda: old_k2(e3, ep, params, shear, bulk, apply,
                                                       apex), reps=100)[0]]
                t_old_path = [cuda_ms(old_path, reps=100)[0]]
                t_new = [cuda_ms(lambda: rm.dp_return_map_cuda(*new_args),
                                 reps=100)[0] for _ in range(2)]
                t_old_path.append(cuda_ms(old_path, reps=100)[0])
                t_old.append(cuda_ms(lambda: old_k2(e3, ep, params, shear, bulk, apply,
                                                           apex), reps=100)[0])
                floor = cuda_ms(lambda: torch.neg(xf, out=yf), reps=100)[0]
                tag = (f"n{n}_{str(dt)[6:]}_{'ep' if apply else 'noep'}"
                       f"{'_trial' if apex else ''}")
                k2[tag] = dict(bitwise_equal=equal, ms=t_new, earlier_ms=t_old,
                               earlier_path_ms=t_old_path, elementwise_floor_ms=floor)
                print(f"[K2] {tag}: equal {equal} | ms: this "
                      f"{t_new[0]:.5f} {t_new[1]:.5f}, earlier kernel {t_old[0]:.5f} "
                      f"{t_old[1]:.5f}, earlier with unpack and mask {t_old_path[0]:.5f} "
                      f"{t_old_path[1]:.5f}, one elementwise kernel on {n} f32 {floor:.5f} "
                      f"| {card}", flush=True)

    k7 = {}
    for tag, (K, b, _) in k7_matrices(torch, device).items():
        n = K.shape[0]
        L, inv = chol.cholesky_factor(K)
        x_new, x_old = chol.cholesky_solve(L, inv, b, n), old_solve(L, inv, b, n)
        ref = np.linalg.solve(K.double().cpu().numpy(), b.double().cpu().numpy())
        gap = lambda x: float(np.abs(x.double().cpu().numpy() - ref).max()  # noqa: E731
                              / np.abs(ref).max())
        between = float((x_new - x_old).abs().max() / x_old.abs().max())
        L_lib = torch.linalg.cholesky(K)
        reps = 20 if n <= 1000 else 10
        t_old = [cuda_ms(lambda: old_solve(L, inv, b, n), reps=reps)[0]]
        t_new = [cuda_ms(lambda: chol.cholesky_solve(L, inv, b, n), reps=reps)[0]
                 for _ in range(2)]
        t_old.append(cuda_ms(lambda: old_solve(L, inv, b, n), reps=reps)[0])
        t_lib = cuda_ms(lambda: torch.cholesky_solve(b[:, None], L_lib), reps=reps)[0]
        blocks, _ = chol._solve_grid(L.device.index, L.shape[0])
        k7[tag] = dict(n=n, n_pad=L.shape[0], blocks=blocks, gap_between=between,
                       gap_f64=gap(x_new), earlier_gap_f64=gap(x_old), ms=t_new,
                       earlier_ms=t_old, cusolver_ms=t_lib)
        print(f"[K7 solve] {tag} n {n}: {blocks} blocks, this vs earlier {between:.3e}, vs f64 "
              f"{gap(x_new):.3e} (earlier {gap(x_old):.3e}) | ms: this {t_new[0]:.5f} "
              f"{t_new[1]:.5f}, earlier {t_old[0]:.5f} {t_old[1]:.5f}, cuSOLVER {t_lib:.5f} "
              f"| {card}", flush=True)
    line = json.dumps({"card": card, "k2_all_equal": all_equal, "k2": k2, "k7_solve": k7})
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        pathlib.Path(args.out).write_text(line + "\n")
    print(line)
    return 0 if all_equal else 1


if __name__ == "__main__":
    sys.exit(main())
