"""Drucker-Prager strip footing (load-stepped semi-smooth Newton), on the
PyTorch port.

The port's counterpart of `examples/plasticity_dp.py` (the reference's
script `Plasticity2D_DP/sandbox.py`, `elasticity_fem(P1, level=1)`): the
same flags, the same printout.  It runs on the CUDA card; `--cpu` runs it
on the host.  `--figdir DIR` writes the `--draw` figure to DIR as a PNG
file instead of showing it.

    python examples/plasticity_dp_torch.py --etype P1 --level 1 --draw
    python examples/plasticity_dp_torch.py --fast --solver cg --cpu
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--etype", default="P1", choices=["P1", "P2", "Q1", "Q2"])
    p.add_argument("--level", type=int, default=1)
    p.add_argument("--draw", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the host instead of the card")
    p.add_argument(
        "--bug-compatible-apex",
        action="store_true",
        help="reproduce reference defect #2 bit-for-bit (SURVEY.md §2.3)",
    )
    p.add_argument(
        "--fast",
        action="store_true",
        help="double-float fast preset (f32 tangent solves, f64 state and "
        "adaptive schedule — FootingConfig.fast)",
    )
    p.add_argument(
        "--solver", default=None, choices=["dense", "cg"],
        help="tangent solver (cg = matrix-free block-Jacobi PCG, the "
        "large-mesh path)",
    )
    p.add_argument("--figdir", default=None,
                   help="with --draw: write the figure here as PNG instead of showing it")
    args = p.parse_args(argv)

    import numpy as np

    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig
    from fem_elastoplasticity_tpu_torch.models.footing import solve
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType

    kw = dict(
        etype=ElementType[args.etype],
        level=args.level,
        bug_compatible_apex=args.bug_compatible_apex,
    )
    if args.solver:
        kw["solver"] = args.solver
    cfg = FootingConfig.fast(**kw) if args.fast else FootingConfig(**kw)
    res = solve(cfg, device="cpu" if args.cpu else None)
    print(f"accepted steps: {res.n_steps}")
    print(f"Newton iterations: {res.n_newton_total}")
    print(f"yielded integration points: {res.n_plastic}")
    z = np.asarray(res.zeta_hist)
    print("Maximal load factor was achieved." if z.max() >= 1 else "Too small load increments.")
    print("normalized footing pressure:", np.asarray(res.pressure_hist[1 : res.n_steps + 1]))

    if args.draw:
        from fem_elastoplasticity_tpu_torch import viz

        u = np.asarray(res.u)
        u_total = np.sqrt((u**2).sum(axis=1))
        viz.draw_quantity(res.mesh, u / abs(u).max(), u_total, outline="square",
                          show=args.figdir is None)
        if args.figdir is not None:
            viz.save_figures(args.figdir, "plasticity_dp")
    return res


if __name__ == "__main__":
    main()
