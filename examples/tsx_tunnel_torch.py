"""TSX tunnel excavation (Drucker-Prager, unstructured mesh), on the
PyTorch port.

The port's counterpart of `examples/tsx_tunnel.py` (the reference's script
`tsx-tunnel/sandbox.py`, `elasticity_fem(P4, level=1)`): the same flags,
the same printout.  It runs on the CUDA card; `--cpu` runs it on the host.
`--devices N` runs N ranks over torch.distributed (`parallel/sharding.py`;
on the card every rank takes a card, cards shared round robin).
`--figdir DIR` writes the `--draw` figures to DIR as PNG files instead of
showing them.

    python examples/tsx_tunnel_torch.py --etype P1 --draw
    python examples/tsx_tunnel_torch.py --etype P4 --solver cg
    python examples/tsx_tunnel_torch.py --fast            # df32 fast path
    python examples/tsx_tunnel_torch.py --fast --solver mg --refine 3   # 57k DOFs
    python examples/tsx_tunnel_torch.py --support 2.0     # 2 MPa tunnel support
    python examples/tsx_tunnel_torch.py --devices 2       # elements sharded over 2 ranks
    python examples/tsx_tunnel_torch.py --cpu             # on the host
"""
import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--etype", default="P1", choices=["P1", "P2", "P4"])
    p.add_argument("--refine", type=int, default=0, help="uniform refinements")
    p.add_argument("--solver", default="dense", choices=["dense", "cg", "mg"])
    p.add_argument("--fast", action="store_true", help="df32 fast path")
    p.add_argument(
        "--support", type=float, default=0.0,
        help="tunnel support pressure (MPa) on the wall (beyond-reference)",
    )
    p.add_argument("--devices", type=int, default=0, help="shard over N ranks")
    p.add_argument("--draw", action="store_true")
    p.add_argument("--cpu", action="store_true", help="run on the host instead of the card")
    p.add_argument("--figdir", default=None,
                   help="with --draw: write the figures here as PNG instead of showing them")
    args = p.parse_args(argv)

    import numpy as np

    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType

    device = "cpu" if args.cpu else None
    kw = dict(
        etype=ElementType[args.etype],
        refine_levels=args.refine,
        solver=args.solver,
        support_pressure=args.support,
    )
    cfg = TsxTunnelConfig.fast(**kw) if args.fast else TsxTunnelConfig(**kw)

    if args.devices and args.fast:
        # multi-rank df32: the element-sharded fast path, the partial forces
        # summed in rank order (requires solver="cg")
        import dataclasses

        cfg = dataclasses.replace(cfg, solver="cg")
        res = tsx.solve_sharded_df32(cfg, args.devices, device=device)
    elif args.devices:
        res = tsx.solve_sharded(cfg, args.devices, device=device)
    else:
        res = tsx.solve(cfg, device=device)

    print(f"accepted steps: {res.n_steps}")
    print(f"Newton iterations: {res.n_newton_total}")
    print(f"yielded integration points: {res.n_plastic}")
    print(f"tunnel-wall displacement u_x(node 40): {float(res.u[40, 0]):.9e}")

    if args.draw:
        from fem_elastoplasticity_tpu_torch import viz

        u = np.asarray(res.u)
        viz.draw_mesh(res.mesh, show=False)
        viz.plot_load_curve(res.zeta_hist, res.displ_hist, res.n_steps, show=False)
        u_total = np.sqrt((u**2).sum(axis=1))
        viz.draw_quantity(res.mesh, 300 * u, u_total, outline="tsx", show=args.figdir is None)
        if args.figdir is not None:
            viz.save_figures(args.figdir, "tsx_tunnel")
    return res


if __name__ == "__main__":
    main()
