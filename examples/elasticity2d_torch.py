"""Linear elasticity on the square-with-hole domain, on the PyTorch port.

The port's counterpart of `examples/elasticity2d.py` (the reference's script
`Elasticity2D/sandbox.py`, `elasticity_fem(Q2, level=1)`): the same flags,
the same printout.  It runs on the CUDA card; `--cpu` runs it on the host.
`--figdir DIR` writes the `--draw` figures to DIR as PNG files instead of
showing them.

    python examples/elasticity2d_torch.py --etype Q2 --level 1 --draw
    python examples/elasticity2d_torch.py --etype P1 --cpu
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--etype", default="Q2", choices=["P1", "P2", "Q1", "Q2"])
    p.add_argument("--level", type=int, default=1)
    p.add_argument("--draw", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the host instead of the card")
    p.add_argument("--figdir", default=None,
                   help="with --draw: write the figures here as PNG instead of showing them")
    args = p.parse_args(argv)

    from fem_elastoplasticity_tpu_torch.models.config import ElasticityConfig
    from fem_elastoplasticity_tpu_torch.models.elasticity import solve
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType

    cfg = ElasticityConfig(etype=ElementType[args.etype], level=args.level)
    res = solve(cfg, device="cpu" if args.cpu else None)
    print(f"Stored energy: {float(res.energy)}")  # reference E:1172 printout

    if args.draw:
        from fem_elastoplasticity_tpu_torch import viz

        viz.draw_mesh(res.mesh, show=False)
        viz.draw_displacement(res.mesh, res.u, show=args.figdir is None)
        if args.figdir is not None:
            viz.save_figures(args.figdir, "elasticity2d")
    return res


if __name__ == "__main__":
    main()
