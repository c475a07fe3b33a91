"""Write the reference fixtures the PyTorch port's tests read.

Runs the JAX package on the CPU and writes, under tests/fixtures/torch_port/:

* tsx_df32_bench.npz — `TsxTunnelConfig.fast(assembled_cg=True)` (the bench
  preset): u, ep, zeta_hist, displ_hist and the step/Newton/plastic counts;
  plus the native f64 `TsxTunnelConfig()` field as u_f64;
* tsx_df32_carry9.npz — the bench preset's load-stepping carry after 9 load
  trips (`solve/chunked.py carry_of`, written by `save_checkpoint`);
* tsx_f64_maxit2.npz — native f64 with newton_maxit=2: plastic steps fail,
  d_zeta halves until it underflows d_zeta_min (the reject path);
* tsx_f32.npz — `TsxTunnelConfig.fast_f32()`, the pure-f32 preset whose
  return map is the Pallas kernel: u, ep, zeta_hist, displ_hist and the
  step/Newton/plastic counts;
* footing_f64.npz — `FootingConfig()`, the strip footing's native f64
  parity run: u, ep, zeta_hist, pressure_hist and the counts;
* footing_f32.npz — `FootingConfig.fast_f32()`, the same fields;
* tsx_scale_l1.npz — `TsxTunnelConfig.fast_scale(1)`, the multigrid-CG
  scale preset on the once-refined mesh (3,678 DOFs), full schedule: u in
  reference node order, ep, zeta_hist, displ_hist and the step, Newton, CG
  and plastic counts (compressed);
* tsx_scale_l2_2steps.npz — `TsxTunnelConfig.fast_scale(2, zeta_max=2/17)`,
  two load steps on the twice-refined mesh (14,450 DOFs), the same fields.

The port's tests compare against these files instead of re-running a JAX
solve (about 30 s of compilation each; the two scale files run their
Pallas kernels in interpret mode and take about 35 s and 45 s).
Run from the repository root, optionally naming the files to write
(default: all):

    python tools/make_port_fixtures.py [tsx_f32 footing_f64 ...]
"""
from __future__ import annotations

import dataclasses
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = ROOT / "tests" / "fixtures" / "torch_port"


def _fields(r, monitor: str) -> dict:
    import numpy as np

    return dict(
        u=np.asarray(r.u, np.float64),
        ep=np.asarray(r.ep, np.float64),
        zeta_hist=np.asarray(r.zeta_hist, np.float64),
        **{monitor: np.asarray(getattr(r, monitor), np.float64)},
        n_steps=r.n_steps,
        n_newton_total=r.n_newton_total,
        n_plastic=r.n_plastic,
    )


def main(names) -> None:
    sys.path.insert(0, str(ROOT))
    import jax

    jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from fem_elastoplasticity_tpu.models import footing
    from fem_elastoplasticity_tpu.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu.models.config import FootingConfig, TsxTunnelConfig
    from fem_elastoplasticity_tpu.solve.chunked import carry_of, save_checkpoint

    OUT.mkdir(parents=True, exist_ok=True)
    names = set(names or FIXTURES)
    if "tsx_f32" in names:
        r = tsx.solve(TsxTunnelConfig.fast_f32())
        np.savez(OUT / "tsx_f32.npz", **_fields(r, "displ_hist"))
    if "footing_f64" in names:
        r = footing.solve(FootingConfig())
        np.savez(OUT / "footing_f64.npz", **_fields(r, "pressure_hist"))
    if "footing_f32" in names:
        r = footing.solve(FootingConfig.fast_f32())
        np.savez(OUT / "footing_f32.npz", **_fields(r, "pressure_hist"))
    for name, cfg in (
        ("tsx_scale_l1", lambda: TsxTunnelConfig.fast_scale(1)),
        ("tsx_scale_l2_2steps", lambda: TsxTunnelConfig.fast_scale(2, zeta_max=2 / 17)),
    ):
        if name in names:
            r = tsx.solve(cfg())
            np.savez_compressed(
                OUT / f"{name}.npz", **_fields(r, "displ_hist"), n_cg_total=r.n_cg_total
            )
    if not names & {"tsx_df32_bench", "tsx_f64_maxit2", "tsx_df32_carry9"}:
        _report()
        return

    cfg = TsxTunnelConfig.fast(assembled_cg=True)
    r = tsx.solve(cfg)
    r64 = tsx.solve(TsxTunnelConfig())
    np.savez(
        OUT / "tsx_df32_bench.npz",
        u=np.asarray(r.u, np.float64),
        ep=np.asarray(r.ep, np.float64),
        zeta_hist=np.asarray(r.zeta_hist, np.float64),
        displ_hist=np.asarray(r.displ_hist, np.float64),
        n_steps=r.n_steps,
        n_newton_total=r.n_newton_total,
        n_plastic=r.n_plastic,
        u_f64=np.asarray(r64.u, np.float64),
    )

    r2 = tsx.solve(TsxTunnelConfig(newton_maxit=2))
    np.savez(
        OUT / "tsx_f64_maxit2.npz",
        u=np.asarray(r2.u, np.float64),
        zeta_hist=np.asarray(r2.zeta_hist, np.float64),
        displ_hist=np.asarray(r2.displ_hist, np.float64),
        n_steps=r2.n_steps,
        n_newton_total=r2.n_newton_total,
    )

    run, args, _ = tsx.build_df32(dataclasses.replace(cfg, max_trips=9))
    save_checkpoint(OUT / "tsx_df32_carry9.npz", carry_of(run(args)))
    _report()


def _report() -> None:
    for f in sorted(OUT.glob("*.npz")):
        print(f.relative_to(ROOT), f.stat().st_size, "bytes")


FIXTURES = (
    "tsx_df32_bench", "tsx_f64_maxit2", "tsx_df32_carry9",
    "tsx_f32", "footing_f64", "footing_f32", "tsx_scale_l1", "tsx_scale_l2_2steps",
)

if __name__ == "__main__":
    unknown = set(sys.argv[1:]) - set(FIXTURES)
    if unknown:
        sys.exit(f"unknown fixtures {sorted(unknown)}; known: {FIXTURES}")
    main(sys.argv[1:])
