#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA card.

Drives the port's paths through the entry points a user calls and checks
them against the repository's anchors:

  1. device   — a CUDA card is required; prints its name and power limit
                as `nvidia-smi --query-gpu=name,power.limit` gives them;
  2. build    — builds kernels K1 and K3's CSR kernel (one template,
                ops/csrc/csr_spmv.cu: the residual, the footing scale
                path's Galerkin value maps, the high-order f32 heads of G
                and S), K2 and its member-batched instance
                (ops/csrc/dp_return_map.cu), K3's product on
                node blocks (ops/csrc/block_jacobi_sweep.cu) and its
                transfers (ops/csrc/node_transfer.cu), K4 and K5
                (ops/csrc/block_jacobi_sweep.cu), K6 (ops/csrc/ell_spmv.cu)
                and K7 (ops/csrc/cholesky_blocked.cu) with nvcc, one process
                a source, all at once;
  3. K1       — the kernel against its plain PyTorch version on the strain
                and force operators G/S of the tsx mesh at refine levels 0
                and 4, seeded inputs, normwise relative difference <= 1e-13;
                CUDA-event times of both, the bytes bound, and cuSPARSE's
                time for the same product (`torch.sparse_csr_tensor @ x`);
                the operator's row blocks (`ops.spmv.row_blocks`) printed,
                and every f32 operator (K3's CSR kernel, later phases) also
                bitwise equal to the row-serial loop
                `spmv.csr_matvec_row_serial`;
  4. K2       — the kernel against its plain version at 896 points (the
                main path's) and 227,072 (tsx refine 4), f32 and f64, with
                and without the plastic-strain update, both apex modes: one
                launch's s, D (3, 3, n), ind_p and ep bitwise the plain
                version's with `unpack_tangent` and `lam > 0` (initial
                strain zeta * e0_dir), identical branch masks, max abs
                difference over max |plain| <= 1e-6 (f32) / 1e-13 (f64),
                two launches bit-identical; CUDA-event times beside the
                bytes bound (89 bytes a point in f32, 177 in f64: D's six
                unique values), at 896 points one PyTorch elementwise
                kernel on 896 values (the launch floor), at 227,072 also
                with L2 flushed before each launch; the Newton loop's entry
                `dp_return_map_newton`, run under torch.profiler beside a
                marker kernel, launches one kernel on the card, K2 (a
                profile that lost the marker or the entry's kernels is
                taken again, 3 tries; failing that, the kernels are
                counted from the operators the entry dispatches and K2's
                launch count);
  5. K7       — `cholesky_factor` and `cholesky_solve` (its own entry
                points; no solve calls it) on the seeded SPD matrices of
                `tests/test_cholesky_pallas.py` at n = 128, 200, 908 and
                2000, the Jacobi-scaled tsx elastic K_free (908) and the
                footing's f32 K_free (816), then each case against the
                plain version: factor and inverse blocks within 1e-5 of max
                |plain|, the solve within 1e-5 of the plain solve on the
                kernel's factor, within 5e-6 (SPD) or 1e-4 (FEM) of the f64
                solve, two launches bit-identical; the kernels each
                factorization launched, as the library reports them, must
                be one (a cooperative launch); times beside the bound (the
                solve's: the entries of L below its diagonal blocks and the
                lower triangles of the inverses, within n, read once), the
                plain version and cuSOLVER (`cholesky_ex`, `cholesky_solve`);
  6. f64      — `solve(TsxTunnelConfig())`: 17 steps, 28 Newton iterations,
                u[40,0] within 1e-9 relative of the f64 anchor;
  7. bench    — `TsxTunnelConfig.fast(assembled_cg=True)`: the same gate,
                K1 launched (and the plain version not) during the solve,
                and two runs with identical counts and bit-identical u;
  8. tsx f32  — `solve(TsxTunnelConfig.fast_f32())`: 17 steps, u[40,0]
                within 1e-5 relative of -1.979450e-03, K2 launched once a
                return map of the Newton loop (its calls of
                `dp_return_map_newton` counted) and the plain version not,
                two runs
                with equal counts and bit-identical u, its u sha256
                printed;
  9. footing f64 — `footing.solve(FootingConfig())`: 16 steps, zeta ending
                at 1.032 (1e-12), the reference's 16 pressures within 1e-4;
 10. footing f32 — `footing.solve(FootingConfig.fast_f32())`: zeta reaches
                1, the limit pressure within 5e-4 of the f64 run's, K2
                launched once a return map of the Newton loop and the plain
                version not, two runs with equal
                counts and bit-identical u, its u sha256 printed;
 11. footing df32 — `footing.solve(FootingConfig.fast())`: 16 steps, zeta
                within 1e-6, u within 1e-9, pressures within 1e-5 of the f64
                run's, two runs bit-identical, steps and plastic points as
                the JAX package's run has them (tests/fixtures/torch_port/
                footing_df32.npz) and its Newton iterations on every load
                trip, or fewer on a trip at its two-float floor
                (`footing.newton_trip_gaps`);
 12. footing CG — `FootingConfig(solver="cg")`, `FootingConfig.fast(
                solver="cg")` and `FootingConfig.fast(solver="cg",
                assembled_cg=True, cg_maxiter=4000)` at zeta_max=0.02
                against their fixtures: steps and plastic points as the JAX
                package's runs have them, Newton iterations by trip as in
                phase 11 (df32) or in total (f64), CG within 5%, the last
                pressure within 1e-8 (f64) / 1e-6 (df32), each run once,
                the matrix-free runs through no
                kernel, the assembled run through K3's node-block product
                (at least once a CG iteration) and K1, no plain version and
                no CSR K3, its schedule the matrix-free df32 run's;
 13. footing L3 — `build_df32(FootingConfig.fast(level=3, solver="cg",
                assembled_cg=True, cg_maxiter=4000, max_trips=2))` (13k
                unknowns; setup time printed), two runs bit-identical, the
                same gates against the JAX package's 2 / 17 / 21,074 /
                3,004 and pressure 14.473212, K3's product and K1, no plain
                version and no CSR K3;
 14. scale L1 — `solve(TsxTunnelConfig.fast_scale(1))`, the multigrid-CG
                preset on the once-refined mesh: 17 steps, u[40,0] within
                1e-8 relative of -2.166787295662e-03, 20 plastic points, K3
                (both node kernels), K4 and K1 launched, no plain version
                and no CSR K3 (phases 17 and 21 too); the sha256 of u's
                f64 bytes printed (phases 17 and 21 too), so that two trees'
                runs compare bit for bit;
 15. K3       — the product on f32 node blocks (`node_block_spmv`) on the
                fine elastic operators of the level-1 and level-4
                hierarchies and, after phase 21's build, of level 5, and the
                transfers (`node_transfer`) of every level of the level-4
                and level-5 hierarchies, R masked with the coarse level's
                free DOFs and P masked and added to z as the V-cycle runs
                them, seeded inputs: each bitwise equal to its plain
                version, to the earlier design (the f32 CSR kernel on the
                host CSR, then `torch.where` and the add) and to itself on
                a second launch; device (CUDA graph) and eager times beside
                the CSR kernel's (with its elementwise ops) and cuSPARSE's
                product on the same CSR, the bound of the layout's bytes
                and that of the CSR's;
 16. K4       — the fused block-Jacobi sweep on the 2x2 node blocks
                (`ops.spmv.node_blocks`; blocks a node printed) of the
                level-4 and level-1 fine operators, and after phase 21's
                build on levels 1-4 of the level-5 hierarchy (their CSR
                from the host hierarchy), seeded z and r, with and without
                the update: bitwise equal to its plain version on the
                blocks, <= 5e-6 of the plain version on the CSR, exact
                zeros on constrained rows, two launches bit-identical;
                times, the bound of the layout's bytes and that of the CSR
                entries' bytes;
 17. scale L4 — `build_df32(TsxTunnelConfig.fast_scale(4))` (setup time
                printed), then two runs: 17 steps, u[40,0] within 1e-6
                relative of -2.264312e-3, the step / Newton / CG / plastic
                counts beside the JAX package's recorded 17 / 52 / 605 /
                1,477, equal counts and bit-identical u in both runs, K3, K4
                and K1 launched, no plain version and no CSR K3;
 18. K6       — the sliced ELL product against its plain version: f32 on
                the level-4 fine operator, its P and R (the ELL build of
                `spmv_fmt="ell"`), f64 on level 4's G and S, each one
                operator (`residual_fmt="ell"`): one launch a product, <=
                2e-6 of max |plain| (f32), <= 1e-13 normwise (f64), two
                launches bit-identical; slice widths, tail entries, times,
                bytes bound (the entries', as for the CSR kernels; the
                sliced layout's bytes printed beside it), cuSPARSE's time
                for the same product and K3's / K1's time on the same
                operator as CSR;
 19. scale ELL — `fast_scale(L, spmv_fmt="ell", corr_mode="gather",
                residual_fmt="ell")` through `solve` at L = 1 (u40 within
                1e-8 of -2.166787295662e-03) and `build_df32` at L = 4
                (within 1e-6 of -2.264312e-3): 17 steps, two runs with equal
                counts and bit-identical u, both K6 instances launched, no
                plain version and no K3 or K1 (every operator is ELL);
                counts printed beside the slot path's;
 20. K5       — the sweep on bf16 node blocks of the level-5 fine operator
                (910,368 rows) and of the level-1 fine operator packed by
                force (the blocks must be the f32 blocks of the level,
                rounded), with and without the update: bitwise equal to its
                plain version on the blocks and to K4 on the values widened
                to f32, <= 5e-6 of the CSR plain version, exact zeros on
                constrained rows, two launches bit-identical; times, both
                bounds, and K4's time on the level-5 operator's f32 blocks;
 21. scale L5 — `build_df32(TsxTunnelConfig.fast_scale(5))` (setup time,
                hierarchy rows and packed levels printed), two runs: 17
                steps, u[40,0] within 1e-6 relative of -2.265345e-3, counts
                beside the JAX package's 17 / 59 / 917, equal counts and
                bit-identical u, K5, K4, K3 and K1 launched, no plain
                version and no CSR K3, K4 as often on each of levels 1-4 as
                K5 on the fine level, the transfers twice a V-cycle level;
                the solve's peak device memory (reset before its setup).
 22. elasticity — `models.elasticity.solve`: the dense energies of P1 L1,
                P1 L2, Q1 L1 and Q2 L1 within 1e-10 of their anchors, the P2
                hole mesh solves, CG at level 1 within 1e-11 of dense (P1,
                Q2), CG at level 5 (154,882 DOFs) within 1e-9 of the JAX
                package's energy (fixture elasticity_cg.npz), no kernel
                launched;
 23. footing scale L2, L3 — `build_df32(FootingConfig.fast_scale(L,
                max_trips=3))` at L = 2 (undamped and with newton_damping=3)
                and 3, against the JAX package's runs (fixtures
                footing_scale_*_t3.npz): steps equal, Newton iterations by
                trip (`footing.newton_trip_gaps`), CG within 5%, accepted
                load factors within 1e-12, pressures within 1e-5, two runs
                bit-identical; K1, K3's product, transfers and CSR kernel
                (the Galerkin value maps, one launch a coarse level a
                Newton iteration) and K4 launched, no plain version; before
                the runs, the path's kernels at the shapes of L2 and L3 as
                in phase 24;
 24. new shapes — at level 4 (and at L2, L3 in phase 23, L5 in phase 26,
                `footing_scale_phase`): K1 on the footing's G and S, K3's
                CSR kernel on every Galerkin value map, K3's product on the
                fine blocks refreshed from a seeded tangent and the
                hierarchy's transfers (`k3_phase`), K4 on every refreshed
                level (`k4_phase`), each against its plain version and
                beside cuSPARSE where a call exists;
 25. footing scale L4 — `fast_scale(4, max_trips=3)` (51,842 DOFs) twice:
                counts, walls, the wall a CG iteration and u's digest
                printed, bit-identical, the launches as in phase 23;
 26. footing scale L5 — `fast_scale(5, max_trips=1)`, damped, resumed from
                `checkpoints/footing_l5_k16.npz` (`utils.convert.
                load_checkpoint`): the path's kernels at level 5's shapes
                as in phase 24; setup, the trip's Newton and CG counts,
                zeta, d_zeta and wall printed, the launches as in phase 23,
                twice bit-identical unless one trip takes over 120 s.

 27. tsx P4 — the reference's own configuration on the production
                route, `build_df32(TsxTunnelConfig.fast(etype=P4,
                solver="ell"))` (p-multigrid through the P1 hierarchy of the
                P4 node lattice, gs_tangent auto: the tangent S (d (G v)) on
                the f32 heads of G and S through K3's CSR kernel), full
                schedule, twice: 17 steps / 40 Newton iterations / 79
                plastic points (the f64 anchor's; by trip where it parts),
                u40 within 1e-6 of -2.267020043e-03, bit-identical; setup,
                walls, CG total, the profiled run's idle share; K1, K3's
                CSR kernel and transfers and K4 launched, no plain version
                and no product of the P1 fine operator;
 28. high-order routes — P2 cut at zeta 2/17 and P4 at 1/17 on five routes
                (`TsxTunnelConfig(solver="cg")` native f64,
                `fast(solver="cg")`, `fast(solver="cg", assembled_cg=True)`,
                `fast(solver="ell")` with gs_tangent True and False), each
                built from the configuration its fixture stores, twice
                each, against the JAX runs (fixtures tsx_p2_*_z2.npz,
                tsx_p4_*_z1.npz; elastic): steps and plastic points equal,
                Newton iterations by trip (`footing.newton_trip_gaps`) or in
                total (native), CG within 5% (not held for the P4
                matrix-free route, HIGH_ORDER_CG_FREE), u within 1e-9,
                bit-identical; the matrix-free routes launch nothing, the
                assembled one K3's product (once a CG iteration at least)
                and K1, p-multigrid as phase 27;
 29. high-order plastic routes — the routes past the first plastic step
                (load step 11), once each, by phase 28's rules: P2
                p-multigrid with gs_tangent True and False at the full
                schedule (fixtures tsx_p2_pmg_*_z17.npz) against its own
                route's JAX run, and P4 p-multigrid with gs_tangent True and
                False at 12/17 against the JAX matrix-free df32 run (CG
                not held: another preconditioner); plastic points and a
                trip of more than one Newton iteration in every run; the
                block-Jacobi routes (P2 full schedule, P4 cut at 12/17)
                run in `tools/high_order_plastic.py` since phases 34-36;
 30. 228,112 DOFs — `fast(etype=P4, solver="ell", refine_levels=2)` and
                `fast(etype=P2, solver="ell", refine_levels=3)` (the P1
                refine-4 lattice), full schedule, twice each: 17 steps, u40
                within 1% of phase 27's (no JAX run exists at this size: a
                plausibility check), bit-identical, counts, walls, setup
                and peak device memory printed;
 31. high-order kernels — K1 on G and S and K3's CSR kernel on their f32
                heads at P2 and P4 on the tsx mesh and at P4 refine 2
                (`csr_phase`, beside cuSPARSE), K3's product on the
                assembled P2 and P4 elastic K (node blocks a node printed),
                K3's transfers on the P4 and P4-refine-2 p-multigrid levels
                (`k3_phase`) and K4 on the P4 levels and the refine-2 fine
                level (`k4_phase`), each against its plain version by the
                earlier phases' rules;
 32. K2 batched — K2's member-batched instance over the 64 ensemble
                members (`ensemble_grid`) at 896 and 3,584 points a member,
                f32 and f64, both plastic-strain and apex modes: one
                launch `torch.equal` to the batched plain version and to
                64 single K2 launches, two launches bit-identical; times
                beside the bytes bound (89 / 177 bytes a point), the 64
                single launches and the launch floor;
 33. ensembles — the 64 members (the 8 x 8 cohesion x friction grid of
                benchmarks/ensemble_bench.py, member 28 the reference
                material) through `parallel.ensemble`: f32
                (`fast_f32()`), f64 and df32 on the dense solver and df32
                matrix-free CG at refine 1, full schedules, each twice
                (bit-identical) and once profiled; the compared members'
                steps and last zeta those of their single port solves (22
                members of each dense ensemble, `ENSEMBLE_DENSE_SINGLES`,
                2 of the CG one), at least 8 (both on the CG run; the
                weakest and the reference among them) also their Newton
                and plastic counts with u within `ENSEMBLE_U_GATES`; the
                f32 run's return maps all
                K2's batched instance (no single launch, no plain version);
                walls, solves/s, the compared single solves' serial wall,
                device busy and idle share, kernels and host reads a sweep,
                peak device memory.
 34. footing element types — Q1, P2 and Q2 at level 0 with
                `bug_compatible_apex=True`, native f64 dense: the accepted
                schedule equal to the reference's
                (`footing_reference_by_etype.json`) and the pressures within
                1e-11; the same under `FootingConfig.fast()` against the
                f64 runs (steps and schedule equal, u within 1e-9, the
                pressures within 1e-5); Q1 and Q2 at level 1 cut at zeta
                0.005 (0.01 before phase 39) under `fast(solver="cg", assembled_cg=True)`, Q1 with
                residual_fmt "slot" and "rslot" (one CSR route: the two
                runs bitwise equal, which also holds the run repeated), Q2
                with "slot" (`FOOTING_ACG_RUNS`), against
                `fast(solver="cg")` (last pressure within 5e-3, the first
                six within 1e-5), K1 and K3's product launched, no plain
                version;
 35. tsx options — `TsxTunnelConfig(solver="mg", refine_levels=1)` full
                schedule (u within 1e-14 of the port's solver="cg" run),
                `fast(solver="mg", refine_levels=1)` (17 steps, 20
                plastic, u40 within 1e-8 of -2.166787295662e-03), the
                support pressure (P1 full schedule, u40 within 1e-9 of
                -1.922609586e-03 and its JAX fixture; P2 and P4 cut at
                2/17: less closure), the W-cycle at L1 (JAX fixture) and L4
                (phase 16's anchor), its CG totals and K3 / K4 launches
                beside the V-cycle's, the deflated CG at L1 (cut at 3/17
                and full schedule, JAX fixtures), `cg_structure="scan"`
                bitwise the "while" run, P2 p-multigrid on ELL residual
                operators (K6 f64 and f32, no CSR product) against the CSR
                route, and a chunked run interrupted and finished from its
                checkpoint in a fresh executor, bitwise the single run;
 36. option kernels — K1 on the footing's G and S at Q1,
                P2 and Q2 (level 1), K3's product on their assembled
                elastic K (node blocks a node printed), K4 on the levels
                the W-cycle visits twice (L4 levels 1-3), K6 f64 and f32 on
                P2 and P4 G, S and their f32 heads, each by the earlier
                phases' rules;
 37. sharded runs on one card — `parallel/sharding.py`: N ranks on the
                card over gloo (every rank's tensors on cuda:0; each
                rank's backend and device printed, none on the CPU, none
                with JAX loaded), one spawn a rank count:
                `solve_sharded` at 2 ranks over the full schedule (the
                single card's CG solve's 17 steps and Newton iterations, u
                within 1e-14), `solve_sharded_df32` at 2 ranks (1e-12
                relative), the 64-member df32 parity ensemble at 2 ranks
                against phase 33's one-card ensemble, the dry run's four
                parts at 2 ranks (`sharding.dryrun_rank`: the JAX
                package's `dryrun_multichip`) under `check_dryrun`'s
                gates, its deflated parts (`fast_scale(1, zeta_max=3/17,
                cg_deflate=4)`, the footing's L3 tangent multigrid with
                cg_deflate=8 to zeta 0.002) bitwise their single-card
                runs, `solve_sharded_scale` of fast_scale(4) at 2 ranks
                (at 4 in a spawn of their own before phase 39) and
                fast_scale(1) at 8, each bitwise the single card's u
                digest and counts (phases 17 and 14), the footing's
                tangent multigrid at L2 cut at zeta 0.004 (its first load
                trip) at 8 ranks bitwise the single card's run; walls,
                gathers and launches of every run;
                then K4's split-z instance on L4's levels 1-4 cut into 4
                row slices, each launch bitwise its plain version and the
                unsharded sweep's rows, times beside the unsharded sweep
                and the bound;
 38. side layers — the example scripts `examples/{elasticity2d,plasticity_dp,
                tsx_tunnel}_torch.py` in-process at their defaults (Q2
                energy within 1e-10, the footing's 16 steps and pressures
                within 1e-4 of the reference's, the tsx's 17 / 28 and u40
                within 1e-9), with `--draw` under Agg where matplotlib is
                installed (each figure non-empty); the bench preset split
                at zeta 8/17 through a `utils.checkpoint` file and resumed,
                bitwise phase 7's u with 17 / 28 (K1 launched); the
                preset under `utils.timing`'s Timer, time_call and trace
                (a Chrome trace written), `utils.metrics.log_run` on it
                (17 step records).
 39. sweeps   — the nine sweeps of `fem_elastoplasticity_tpu_torch/
                benchmarks/` in-process: the assembly pipeline at levels
                0-5 (to 908,288 elements, no kernel), the solve sweep
                (multigrid at levels 0-3, one Newton iteration at 0-2,
                block-Jacobi at 0-1; level 0 within one CG iteration of
                the JAX record, `benchmark_sweeps.json`), `spmv_bench` at
                level 4 (K6 within 2e-6 of the matrix-free product),
                `run_dp_scale` at levels 1-3 (L1: 17 / 37 / 20, u40
                within 1e-8, CG within 5% of JAX, the counts of phase 14),
                the elastic df32 sweeps at levels 0-4 (matrix-free) and
                0-4 slot / 4 ELL (`u_max` within 1e-11 of an f64 CG solve
                at level 1, the three within 1e-9 at level 4), the 8 x 8
                ensemble bench (every member's steps those of phase 33's;
                its grid keeps the JAX bench's member 28, so the Newton
                and plastic counts and u of the 63 shared members are
                printed beside phase 33's), 16 CG members at refine 1 to zeta 3/17, the footing
                sweep at level 1 to zeta 0.02, one run (JAX's record: steps and
                plastic points, Newton by trip, CG within 5%, pressure
                within 1e-6) and its scale preset at level 2 over three
                trips (phase 23's gates), the P4 bench (17 / 40 / 79, u40
                within 1e-6, the counts of phase 27); each sweep's
                kernels launched and no plain version, and one record of
                each sweep that reaches a kernel under torch.profiler,
                its kernels among the profile's (the ensemble and P4
                benches' presets cut at 1/17 for it).

Every phase prints its lines with the card line beside its numbers, and
the later phases their seconds.  Before
the last line it prints the run's total wall and a JSON line with the kernel
table; the last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Any failed check exits non-zero before that line.

    python3 chip_smoke.py
"""
from __future__ import annotations

import concurrent.futures
import hashlib
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
# the port's measurement helpers; alone, without the repository, the script
# stops here
sys.path.insert(0, str(ROOT))
from fem_elastoplasticity_tpu_torch.utils.timing import (  # noqa: E402
    cuda_ms,
    idle_share,
    profiled_kernels,
)

ANCHOR_U40_F64 = -1.9794499636012143e-03
ANCHOR_U40_F32 = -1.979450e-03  # tests/test_pallas_return_map.py:89
K1_TOL = 1e-13  # normwise relative, kernel vs plain, both f64
K2_TOL = {"float32": 1e-6, "float64": 1e-13}  # max abs diff / max |plain|
K3_TOL = 2e-6  # max abs diff / max |plain|: cuSPARSE against K3, both f32
K4_TOL = 5e-6
K5_TOL = 5e-6
K6_TOL = {"float32": 2e-6, "float64": 1e-13}  # max-abs over max |plain|; normwise
K7_TOL = 1e-5  # max-abs over max |plain|: factor, inverses, solve on one factor
# the f64 solve: the JAX package's own gates (tests/test_cholesky_pallas.py);
# the FEM matrices (cond ~1e3 and 6e3) lose more in f32
K7_TOL_F64 = {"spd": 5e-6, "fem": 1e-4}
K7_SIZES = (128, 200, 908, 2000)
# the JAX package's footing runs on the CPU (tools/make_port_fixtures.py)
FIXTURES = ROOT / "tests" / "fixtures" / "torch_port"
# the level-3 assembled run under max_trips=2 (no fixture): steps / Newton /
# CG / plastic and the last accepted pressure
JAX_FOOTING_ACG_L3 = ((2, 17, 21074, 3004), 14.473212, None)
ANCHOR_U40_SCALE_L1 = -2.166787295662e-03  # tests/test_tsx_tunnel.py:236
ANCHOR_U40_SCALE_L4 = -2.264312e-3  # BENCH_NOTES.md:436
JAX_COUNTS_SCALE_L4 = (17, 52, 605, 1477)  # steps, Newton, CG, plastic (BENCH_NOTES.md:124)
ANCHOR_U40_SCALE_L5 = -2.265345e-3  # BENCH_NOTES.md:142
JAX_COUNTS_SCALE_L5 = (17, 59, 917)  # steps, Newton, CG (BENCH_NOTES.md:126)
ANCHOR_U40_P4 = -2.267020043e-03  # tests/test_tsx_tunnel.py:373, PARITY.md
JAX_COUNTS_P4 = (17, 40, 79)  # steps, Newton, plastic of the f64 P4 run (PARITY.md)
SEED = 20261016
# stored energies of the square with a hole (tests/test_elasticity.py:17-23)
ELASTICITY_ANCHORS = {("P1", 1): 2786.3472189077, ("P1", 2): 2717.5492666201,
                      ("Q1", 1): 2728.399597423172, ("Q2", 1): 2642.1861301492}
# one load trip of the level-5 footing resumed from the banked checkpoint
# runs twice only below this wall; above it bit-identity is held at level 4
L5_REPEAT_LIMIT_S = 120.0
# NVIDIA H100 SXM data sheet: HBM3 rate, and the f32 / f64 rates outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}
K2_FLOPS_PER_POINT = 150
# a point reads e3 and ep (7 values) and writes s, D's six unique values,
# lam, ep (15) and a byte of mask; the kernel also stores D's three mirrored
# values, which the function does not need
K2_BYTES_PER_POINT = {"float32": 7 * 4 + 15 * 4 + 1, "float64": 7 * 8 + 15 * 8 + 1}
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


def u_digest(u) -> str:
    """sha256 of u's f64 bytes: two trees' solves compare bit for bit."""
    import numpy as np

    return hashlib.sha256(np.ascontiguousarray(u, dtype=np.float64).tobytes()).hexdigest()


def timed(torch, fn):
    """(result, host wall in s) of fn() ending in a device sync."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def k1_phase(torch, spmv, tsx, asm, ElementType, volume_element, device, card):
    cases = {}
    for level in (0, 4):
        mesh = tsx.tsx_mesh(ElementType.P1, level)
        coords = torch.as_tensor(mesh.coords, dtype=torch.float64, device=device)
        geom = asm.compute_geometry(coords, mesh.elems, volume_element(ElementType.P1))
        G, S = spmv.build_residual_csr(
            geom.B.cpu().numpy(), geom.weight.cpu().numpy(), geom.edofs.cpu().numpy(),
            geom.n_q, geom.n_nodes,
        )
        cases[f"G_L{level}"] = spmv.csr_to_device(G, device)
        cases[f"S_L{level}"] = spmv.csr_to_device(S, device)
    return csr_phase(torch, spmv, cases, device, card)


def csr_phase(torch, spmv, cases, device, card, seed: int = SEED):
    """cases: {tag: CsrMatrix} -> (per-case records, max abs error).  f64
    values run K1 (normwise relative difference to the plain version <=
    K1_TOL), f32 values K3's CSR kernel (max abs difference over max |plain|
    <= K3_TOL, and bitwise the row-serial loop `csr_matvec_row_serial`:
    each row summed in CSR order); each also bitwise repeatable, and beside
    cuSPARSE.  The records carry the operator's row blocks."""
    gen = torch.Generator(device=device).manual_seed(seed)
    shapes, max_err = {}, 0.0
    for tag, A in cases.items():
        f64 = A.values.dtype == torch.float64
        name, kernel = ("K1", spmv.csr_spmv_f64_cuda) if f64 else ("K3 CSR", spmv.csr_spmv_f32_cuda)
        x = torch.randn(A.shape[1], generator=gen, dtype=A.values.dtype, device=device)
        y = kernel(A, x)
        y_plain = spmv.csr_matvec_plain(A, x)
        torch.cuda.synchronize()
        err = float((y - y_plain).abs().max())
        if f64:
            rel = float(torch.linalg.norm(y - y_plain) / torch.linalg.norm(y_plain))
        else:
            rel = err / float(y_plain.abs().max())
        tol = K1_TOL if f64 else K3_TOL
        check(rel <= tol, f"{name} {tag}: relative difference {rel:.3e}")
        check(torch.equal(y, kernel(A, x)), f"{name} {tag}: not bitwise repeatable")
        if not f64:
            check(torch.equal(y, spmv.csr_matvec_row_serial(A, x)),
                  f"{name} {tag}: not bitwise the row-serial sum")
        # the yardstick: one PyTorch call (cuSPARSE) for the same product
        A_lib = torch.sparse_csr_tensor(
            A.indptr, A.indices, A.values, A.shape, check_invariants=False)
        y_lib = torch.mv(A_lib, x)
        torch.cuda.synchronize()
        if f64:
            lib_rel = float(torch.linalg.norm(y_lib - y_plain) / torch.linalg.norm(y_plain))
        else:
            lib_rel = float((y_lib - y_plain).abs().max()) / float(y_plain.abs().max())
        check(lib_rel <= tol, f"{name} {tag}: cuSPARSE differs by {lib_rel:.3e}")
        ms, eager_ms = cuda_ms(lambda: kernel(A, x))
        plain_ms, plain_eager_ms = cuda_ms(lambda: spmv.csr_matvec_plain(A, x))
        lib_ms, lib_eager_ms = cuda_ms(lambda: torch.mv(A_lib, x))
        nnz, vsize = int(A.values.numel()), (8 if f64 else 4)
        # entries (value and column) and row offsets, x read and y written once
        n_bytes = (vsize + 4) * nnz + 4 * (A.shape[0] + 1) + vsize * (A.shape[1] + A.shape[0])
        b_ms, b_by = bound_ms(n_bytes, 2 * nnz, "float64" if f64 else "float32")
        max_err = max(max_err, err)
        n_blocks = int(A.row_blocks.shape[0]) - 1
        shapes[tag] = dict(
            rows=A.shape[0], cols=A.shape[1], nnz=nnz, row_blocks=n_blocks,
            rel=rel, max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
            eager_ms=eager_ms, plain_eager_ms=plain_eager_ms,
            library_eager_ms=lib_eager_ms, bytes=n_bytes, bound_ms=b_ms, bound_by=b_by,
        )
        say(name, f"{tag} {A.shape[0]}x{A.shape[1]} nnz {nnz}, {n_blocks} row blocks (E "
            f"{spmv.ROW_BLOCK_ENTRIES}, T {spmv.ROW_BLOCK_ROWS}"
            f"{', streamed' if spmv.csr_streams(A) else ''}): "
            f"rel {rel:.3e} max_abs {err:.3e}{'' if f64 else ', bitwise row-serial'} | "
            f"device: kernel {ms:.5f} ms plain "
            f"{plain_ms:.5f} ms cuSPARSE {lib_ms:.5f} ms bound {b_ms:.5f} ms ({b_by}) | "
            f"eager: kernel {eager_ms:.5f} ms plain {plain_eager_ms:.5f} ms "
            f"cuSPARSE {lib_eager_ms:.5f} ms | {card}")
    return shapes, max_err


def cold_ms(torch, fn, reps: int = 30, flush_bytes: int = 2**29):
    """Mean milliseconds of `fn` with L2 flushed before each launch (a sum
    over a 512 MB tensor, ten times the 50 MB L2, queued first: its ~160 us
    on the card outlast the host's enqueue of the events and the launch, so
    the launch waits on the card, not on the host), CUDA events around
    each."""
    flush = torch.ones(flush_bytes // 4, dtype=torch.float32, device="cuda")
    for _ in range(3):
        fn()
    events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(reps)]
    for start, end in events:
        flush.sum()
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in events) / reps


def k2_phase(torch, rm, device, card):
    """K2 against its plain version: s, D, ind_p, lam and ep of one launch
    bitwise the plain version (initial strain zeta * e0_dir), `unpack_tangent`
    and `lam > 0`, at the Newton path's 896 points and at 227,072, f32 and
    f64, every mode; times beside the bound, at 896 the launch floor (one
    PyTorch elementwise kernel on 896 values) and at 227,072 the time with L2
    flushed before each launch.  Then the Newton loop's entry, once under
    torch.profiler at 896 f32 points: one kernel on the card, K2's."""
    import numpy as np

    from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.models.materials import drucker_prager_fit, lame_moduli

    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    eta, c = drucker_prager_fit(cfg.cohesion, cfg.friction_angle)
    zeta = float(np.float32(7 / 17))
    shapes, max_err, bitwise = {}, 0.0, True
    for n in (896, 887 * 4**4):  # the main path's points; tsx refine 4
        rng = np.random.default_rng(SEED + n)
        e3_np = rng.normal(0, 2e-3, (3, n))
        ep_np = rng.normal(0, 2e-4, (4, n))
        e0_np = rng.normal(0, 1e-3, 4)
        floor_ms = None
        if n == 896:  # the card's launch floor in this harness
            xf = torch.ones(n, dtype=torch.float32, device=device)
            yf = torch.empty_like(xf)
            floor_ms = cuda_ms(lambda: torch.neg(xf, out=yf), reps=100)[0]
        for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            e3 = torch.as_tensor(e3_np, dtype=dt, device=device)
            ep = torch.as_tensor(ep_np, dtype=dt, device=device)
            e0_dir = torch.as_tensor(e0_np, dtype=dt, device=device)
            for apply in (False, True):
                for apex in (False, True):
                    if apex and not apply:
                        continue  # the apex mode only changes the plastic-strain update
                    args = (e3, ep, shear, bulk, eta, c, e0_dir, zeta, apply, apex)

                    def plain():
                        s, ds6, lam, ep_ = rm.dp_return_map_plain(
                            e3, ep, shear, bulk, eta, c, e0_dir, zeta, apply, apex)
                        return s, rm.unpack_tangent(ds6), lam > 0.0, lam, ep_

                    got = rm.dp_return_map_cuda(*args)
                    exp = plain()
                    again = rm.dp_return_map_cuda(*args)
                    torch.cuda.synchronize()
                    tag = f"n{n}_{dt_name}_{'ep' if apply else 'noep'}{'_trial' if apex else ''}"
                    ind_k, ind_p = got[2], exp[2]
                    apex_k = ind_k & (got[1] == 0).all(dim=0).all(dim=0)
                    apex_p = ind_p & (exp[1] == 0).all(dim=0).all(dim=0)
                    n_plastic, n_apex = int(ind_p.sum()), int(apex_p.sum())
                    check(0 < n_apex < n_plastic < n, f"K2 {tag}: branches not all hit "
                          f"({n_plastic} plastic, {n_apex} apex of {n})")
                    check(torch.equal(ind_k, ind_p) and torch.equal(apex_k, apex_p),
                          f"K2 {tag}: branch masks differ")
                    rels = []
                    for g, x in zip(got, exp):
                        if x.dtype == torch.bool:
                            continue
                        err = float((g - x).abs().max())
                        rels.append(err / float(x.abs().max()))
                        max_err = max(max_err, err)
                    check(max(rels) <= K2_TOL[dt_name], f"K2 {tag}: relative difference {max(rels):.3e}")
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"K2 {tag}: two launches differ")
                    same = all(g.dtype == x.dtype and torch.equal(g, x) for g, x in zip(got, exp))
                    check(same, f"K2 {tag}: s, D, ind_p, lam, ep not bitwise the plain version's")
                    bitwise = bitwise and same
                    ms, eager_ms = cuda_ms(lambda: rm.dp_return_map_cuda(*args), reps=100)
                    plain_ms, plain_eager_ms = cuda_ms(plain, reps=100)
                    size = 4 if dt == torch.float32 else 8
                    n_bytes = K2_BYTES_PER_POINT[dt_name] * n
                    b_ms, b_by = bound_ms(n_bytes, K2_FLOPS_PER_POINT * n, dt_name)
                    cold = (cold_ms(torch, lambda: rm.dp_return_map_cuda(*args))
                            if n > 896 and not apply else None)
                    shapes[tag] = dict(
                        n=n, dtype=dt_name, apply_plastic_strain=apply, apex_ep_uses_trial=apex,
                        n_plastic=n_plastic, n_apex=n_apex, rel=max(rels), bitwise_equal=same,
                        ms=ms, plain_ms=plain_ms, eager_ms=eager_ms,
                        plain_eager_ms=plain_eager_ms, launch_floor_ms=floor_ms, l2_flushed_ms=cold, bytes=n_bytes,
                        value_bytes=size, bound_ms=b_ms, bound_by=b_by,
                    )
                    extra = ""
                    if floor_ms is not None:
                        extra += f" | launch floor (torch.neg on {n} values) {floor_ms:.5f} ms"
                    if cold is not None:
                        extra += f" | L2 flushed {cold:.5f} ms"
                    say("K2", f"{tag}: {n_plastic} plastic / {n_apex} apex, rel {max(rels):.3e}, "
                        f"bitwise {same} | device: kernel {ms:.5f} ms "
                        f"plain {plain_ms:.5f} ms bound {b_ms:.5f} ms ({b_by}, {n_bytes} bytes)"
                        f"{extra} | eager: kernel {eager_ms:.5f} ms plain {plain_eager_ms:.5f} ms "
                        f"| {card}")
    kernels, how = newton_entry_kernels(torch, rm, device, shear, bulk, eta, c, zeta)
    check(len(kernels) == 1 and "dp_return_map" in kernels[0],
          f"K2: one Newton return map ran {len(kernels)} kernels on the card ({kernels}; {how})")
    say("K2", f"one Newton return map (`dp_return_map_newton`, 896 f32 points), {how}: "
        f"{len(kernels)} kernel on the card ({kernels[0]}) | {card}")
    return shapes, max_err, bitwise


def dispatched_kernels(torch, rm, fn):
    """The kernels fn() launches on the card without the profiler: K2's
    launches by its count, and every PyTorch operator fn() dispatches on a
    CUDA tensor that is not an allocation or a view (each such operator
    launches a kernel)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    no_kernel = ("empty", "empty_strided", "empty_like")

    class Log(TorchDispatchMode):
        ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            cuda = any(isinstance(t, torch.Tensor) and t.is_cuda
                       for t in torch.utils._pytree.tree_leaves((args, kwargs, out)))
            if cuda and not func.is_view and func.__name__.split(".")[0] not in no_kernel:
                self.ops.append(func.__name__)
            return out

    before = rm.LAUNCHES["dp_return_map"]
    with Log():
        fn()
        torch.cuda.synchronize()
    return ["dp_return_map"] * (rm.LAUNCHES["dp_return_map"] - before) + Log.ops


def newton_entry_kernels(torch, rm, device, shear, bulk, eta, c, zeta):
    """(names of the kernels that one call of the Newton loop's return map
    (`solve.newton.dp_return_map_newton`, 896 f32 points, initial strain
    zeta * e0_dir, no plastic-strain update) runs on the card, how they
    were counted): from torch.profiler, or, where no profile recorded its
    marker and a kernel of the entry, from `dispatched_kernels`."""
    from fem_elastoplasticity_tpu_torch.solve import newton

    e3 = torch.full((3, 896), 1e-3, device=device)
    ep = torch.zeros((4, 896), device=device)
    e0_dir = torch.full((4,), 1e-4, device=device)

    def entry():
        newton.dp_return_map_newton(e3, ep, shear, bulk, eta, c, e0_dir=e0_dir, zeta=zeta)

    entry()
    torch.cuda.synchronize()
    tries = 3
    events, _ = profiled_kernels(entry, tries)
    if events is not None:
        return [e.name for e in events], "under torch.profiler"
    return (dispatched_kernels(torch, rm, entry),
            f"counted from its dispatched operators and K2's launch count (no profile of "
            f"{tries} recorded the marker kernel and a kernel of the entry)")


class CountCalls:
    """Counts the calls of `module.name` while the block runs."""

    def __init__(self, module, name: str):
        self.module, self.name, self.calls = module, name, 0

    def __enter__(self):
        fn = self.fn = getattr(self.module, self.name)

        def counted(*args, **kw):
            self.calls += 1
            return fn(*args, **kw)

        setattr(self.module, self.name, counted)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.fn)


def host_transfers(host: dict):
    """(P, R = P^T) of a host level, scipy CSR, as the hierarchy builds them."""
    import scipy.sparse as sp

    P = sp.csr_matrix(host["P"])
    R = P.T.tocsr()
    R.sum_duplicates()
    return P, R


def k3_cases(spmv, hier, host_levels, device, tag: str, fine_only: bool = False):
    """{case: (node operator, the same operator as f32 CSR, mask, adds)}:
    the fine level's product and, unless `fine_only`, every level's P
    (masked with its own free DOFs and added to z) and R (masked with the
    level below's), as the V-cycle runs them."""
    import numpy as np

    csr = lambda A: spmv.csr_to_device(A, device, np.float32)  # noqa: E731
    levels = hier.levels
    cases = {f"K_{tag}": (levels[-1].op, csr(host_levels[-1]["K"]), None, False)}
    if not fine_only:
        for i in range(1, len(levels)):
            P, R = host_transfers(host_levels[i])
            cases[f"P_{tag}_level{i}"] = (levels[i].P, csr(P), levels[i].free, True)
            cases[f"R_{tag}_level{i}"] = (levels[i].R, csr(R), levels[i - 1].free, False)
    return cases


def k3_phase(torch, spmv, cases, device, card):
    """cases: `k3_cases` -> per-case records.  Each node kernel equals its
    plain version and the earlier design (the CSR kernel, then the
    V-cycle's `torch.where` and add) bit for bit."""
    import numpy as np

    rng = np.random.default_rng(SEED + 3)
    zero = torch.zeros((), dtype=torch.float32, device=device)
    shapes = {}
    for tag, (T, C, mask, adds) in cases.items():
        x = torch.as_tensor(rng.standard_normal(C.shape[1]).astype(np.float32), device=device)
        z = (torch.as_tensor(rng.standard_normal(C.shape[0]).astype(np.float32), device=device)
             if adds else None)
        if isinstance(T, spmv.NodeBlockMatrix):
            kernel = lambda: spmv.node_block_spmv_cuda(T, x)  # noqa: E731
            plain = lambda: spmv.node_block_matvec_plain(T, x)  # noqa: E731
            mode = "product"
        else:
            kernel = lambda: spmv.node_transfer_cuda(T, x, mask, z)  # noqa: E731
            plain = lambda: spmv.node_transfer_plain(T, x, mask, z)  # noqa: E731
            mode = "masked and added" if adds else "masked"

        def earlier():
            # the earlier design: the CSR kernel, then the V-cycle's ops
            y = spmv.csr_spmv_f32_cuda(C, x)
            if mask is not None:
                y = torch.where(mask, y, zero)
            return y if z is None else z + y

        y, y_plain = kernel(), plain()
        torch.cuda.synchronize()
        err = float((y - y_plain).abs().max())
        check(torch.equal(y, y_plain), f"K3 {tag}: not bitwise equal to its plain version")
        check(torch.equal(y, earlier()), f"K3 {tag}: not bitwise equal to the CSR kernel's path")
        check(torch.equal(y, kernel()), f"K3 {tag}: not bitwise repeatable")
        # the yardstick: one PyTorch call (cuSPARSE) for the product on the CSR
        C_lib = torch.sparse_csr_tensor(C.indptr, C.indices, C.values, C.shape,
                                        check_invariants=False)
        y_csr = spmv.csr_spmv_f32_cuda(C, x)
        y_lib = torch.mv(C_lib, x)
        torch.cuda.synchronize()
        lib_err = float((y_lib - y_csr).abs().max())
        lib_rel = lib_err / float(y_csr.abs().max())
        check(lib_rel <= K3_TOL, f"K3 {tag}: cuSPARSE differs by {lib_rel:.3e}")
        # in turns: kernel, earlier design, cuSPARSE, plain, then again
        ms, eager_ms = cuda_ms(kernel)
        csr_ms, csr_eager_ms = cuda_ms(earlier)
        lib_ms, lib_eager_ms = cuda_ms(lambda: torch.mv(C_lib, x))
        plain_ms, plain_eager_ms = cuda_ms(plain, reps=50)
        ms2, _ = cuda_ms(kernel)
        csr_ms2, _ = cuda_ms(earlier)
        rows, cols, nnz = C.shape[0], C.shape[1], int(C.values.numel())
        # the epilogue's inputs: a mask byte a row, z
        vec = 4 * (rows + cols) + (rows if mask is not None else 0) + (4 * rows if adds else 0)
        if mode == "product":
            layout = 20 * T.block_cols.numel() + 4 * (T.n_nodes + 1) + vec
        else:
            layout = 8 * T.node_cols.numel() + 4 * (T.n_nodes + 1) + vec
        csr_bytes = 8 * nnz + 4 * (rows + 1) + vec
        flops = 2 * nnz + (rows if adds else 0)
        b_ms, b_by = bound_ms(layout, flops, "float32")
        csr_b_ms, _ = bound_ms(csr_bytes, flops, "float32")
        shapes[tag] = dict(
            rows=rows, cols=cols, nnz=nnz, mode=mode, max_abs_err=err, bitwise_equal_to_plain=True,
            bitwise_equal_to_csr_kernel=True, ms=ms, ms_again=ms2, eager_ms=eager_ms,
            plain_ms=plain_ms, plain_eager_ms=plain_eager_ms, csr_kernel_ms=csr_ms,
            csr_kernel_ms_again=csr_ms2, csr_kernel_eager_ms=csr_eager_ms, library_ms=lib_ms,
            library_eager_ms=lib_eager_ms, library_max_abs_err=lib_err, bytes=layout,
            bound_ms=b_ms, bound_by=b_by, csr_bytes=csr_bytes, csr_bound_ms=csr_b_ms,
        )
        say("K3", f"{tag} {rows}x{cols} nnz {nnz} ({mode}): bitwise equal to the plain version "
            f"and to the CSR kernel's path | device: kernel {ms:.5f} / {ms2:.5f} ms, CSR kernel "
            f"{'and its ops ' if mask is not None else ''}{csr_ms:.5f} / {csr_ms2:.5f} ms, "
            f"cuSPARSE (product) {lib_ms:.5f} ms (rel {lib_rel:.3e}), plain {plain_ms:.5f} ms, "
            f"bound {b_ms:.5f} ms ({b_by}; the layout's {layout} bytes), CSR bytes' bound "
            f"{csr_b_ms:.5f} ms ({csr_bytes} bytes) | eager: kernel {eager_ms:.5f} ms CSR "
            f"{csr_eager_ms:.5f} ms cuSPARSE {lib_eager_ms:.5f} ms plain {plain_eager_ms:.5f} "
            f"ms | {card}")
    return shapes


def sweep_cost(n: int, nnz: int, n_blocks: int, value_bytes: int, update: bool):
    """(CSR bytes, node-block layout bytes, operations) of one sweep on an
    operator of n rows: each input read once, out written once.  The CSR
    pays a value and an int32 column an entry and n + 1 row offsets, the
    layout 4 values and one int32 node column a block and n/2 + 1 node
    offsets; both read z, r, mask (and msf, mpr with the update) and write
    out."""
    vec = 4 * n * (6 if update else 4)
    csr = (value_bytes + 4) * nnz + 4 * (n + 1) + vec
    layout = (4 * value_bytes + 4) * n_blocks + 4 * (n // 2 + 1) + vec
    return csr, layout, 2 * nnz + (8 if update else 2) * n


def blocks_histogram(torch, B) -> dict:
    """{blocks a node: nodes} of a node-block operator."""
    hist = torch.bincount(B.blocks_per_node().long()).tolist()
    return {k: v for k, v in enumerate(hist) if v}


def k4_phase(torch, spmv, levels, device, card):
    """levels: {tag: (the level's f32 CSR, its MGLevel with f32 node
    blocks)} -> per-case records.
    The kernel equals its plain version on the blocks bit for bit and the
    plain version on the CSR within K4_TOL."""
    import numpy as np

    rng = np.random.default_rng(SEED + 4)
    shapes, max_err = {}, 0.0
    for tag, (A, lev) in levels.items():
        B, aux = lev.sweep_op, lev.aux
        check(B.block_values.dtype == torch.float32, f"K4 {tag}: not f32 node blocks")
        n = A.shape[0]
        hist = blocks_histogram(torch, B)
        say("K4", f"{tag}: {B.n_nodes} nodes, {B.block_cols.numel()} blocks, blocks a node "
            f"{hist} | {card}")
        z = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
        r = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
        # on a like scale: A z is of the stiffness's size
        r = r * spmv.csr_matvec_plain(A, z).abs().max()
        n_fixed = int((aux.mask == 0).sum())
        check(n_fixed > 0, f"K4 {tag}: no constrained row in the operator")
        for update in (True, False):
            case = f"{tag}_{'update' if update else 'residual'}"
            got = spmv.block_jacobi_sweep_cuda(B, aux, z, r, update)
            plain = spmv.node_block_sweep_plain(B, aux, z, r, update)
            exp = spmv.block_jacobi_sweep_plain(A, aux, z, r, update)
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"K4 {case}: not bitwise equal to the block plain version")
            err = float((got - exp).abs().max())
            rel = err / float(exp.abs().max())
            check(rel <= K4_TOL, f"K4 {case}: relative difference {rel:.3e} to the CSR plain")
            fixed = got[aux.mask == 0]
            want = z[aux.mask == 0] if update else torch.zeros_like(fixed)
            check(torch.equal(fixed, want), f"K4 {case}: constrained rows moved")
            check(torch.equal(got, spmv.block_jacobi_sweep_cuda(B, aux, z, r, update)),
                  f"K4 {case}: not bitwise repeatable")
            ms, eager_ms = cuda_ms(
                lambda: spmv.block_jacobi_sweep_cuda(B, aux, z, r, update))
            plain_ms, plain_eager_ms = cuda_ms(
                lambda: spmv.node_block_sweep_plain(B, aux, z, r, update))
            nnz, n_blocks = int(A.values.numel()), int(B.block_cols.numel())
            csr_bytes, layout_bytes, flops = sweep_cost(n, nnz, n_blocks, 4, update)
            b_ms, b_by = bound_ms(layout_bytes, flops, "float32")
            csr_b_ms, _ = bound_ms(csr_bytes, flops, "float32")
            max_err = max(max_err, err)
            shapes[case] = dict(
                rows=n, nnz=nnz, blocks=n_blocks, blocks_a_node=hist,
                constrained_rows=n_fixed, update=update, rel=rel, max_abs_err=err,
                bitwise_equal_to_plain=True, ms=ms, plain_ms=plain_ms, eager_ms=eager_ms,
                plain_eager_ms=plain_eager_ms, bytes=layout_bytes, bound_ms=b_ms,
                bound_by=b_by, csr_bytes=csr_bytes, csr_bound_ms=csr_b_ms,
            )
            say("K4", f"{case} {n} rows nnz {nnz} blocks {n_blocks}: bitwise equal to the block "
                f"plain version, rel {rel:.3e} max_abs {err:.3e} to the CSR plain, {n_fixed} "
                f"constrained rows exact | device: kernel {ms:.5f} ms plain {plain_ms:.5f} ms "
                f"bound {b_ms:.5f} ms ({b_by}; the layout's {layout_bytes} bytes), CSR bytes' "
                f"bound {csr_b_ms:.5f} ms ({csr_bytes} bytes) | eager: kernel {eager_ms:.5f} ms "
                f"plain {plain_eager_ms:.5f} ms | {card}")
    return shapes, max_err


def ell_cost(A, nnz: int, vsize: int):
    """(bytes, flops, layout bytes) of y = A x on an `EllMatrix` holding
    `nnz` entries.  The bound's bytes are what the product needs: each
    entry's value and column once, x read once, y written once.  The layout
    bytes are what the sliced layout reads: every slot (padding included),
    the slice offsets, the tail's row pointers and entries (if any), x and
    y."""
    xy = vsize * (A.shape[1] + A.shape[0])
    n_tail = A.tail_values.numel()  # the kernel reads tail_ptr only if there is a tail
    layout = (A.values.numel() * (vsize + 4) + 4 * A.slice_ptr.numel()
              + (4 * A.tail_ptr.numel() + n_tail * (vsize + 4) if n_tail else 0) + xy)
    return nnz * (vsize + 4) + xy, 2 * nnz, layout


def k6_phase(torch, spmv, cases, device, card):
    """cases: {tag: (ELL operator, the same operator as CSR)} -> records.
    f64 cases are normwise, f32 ones max-abs over max |plain|."""
    import numpy as np

    rng = np.random.default_rng(SEED + 6)
    shapes, max_err = {}, {"float32": 0.0, "float64": 0.0}
    for tag, (A, C) in cases.items():
        dt = A.values.dtype
        dt_name = "float64" if dt == torch.float64 else "float32"
        x = torch.as_tensor(rng.standard_normal(A.shape[1]), dtype=dt, device=device)
        spmv.LAUNCHES.clear()
        y = spmv.sp_matvec(A, x)
        one_launch = dict(spmv.LAUNCHES)
        check(one_launch == {f"ell_spmv_{'f64' if dt == torch.float64 else 'f32'}": 1},
              f"K6 {tag}: a product launched {one_launch}")
        y_plain = spmv.ell_matvec_plain(A, x)
        torch.cuda.synchronize()
        err = float((y - y_plain).abs().max())
        if dt == torch.float64:
            rel = float(torch.linalg.norm(y - y_plain) / torch.linalg.norm(y_plain))
        else:
            rel = err / float(y_plain.abs().max())
        check(rel <= K6_TOL[dt_name], f"K6 {tag}: relative difference {rel:.3e}")
        check(torch.equal(y, spmv.sp_matvec(A, x)), f"K6 {tag}: not bitwise repeatable")
        # the yardsticks: the port's CSR kernel (K3 / K1) and one PyTorch
        # call (cuSPARSE) on the same operator as CSR
        C_lib = torch.sparse_csr_tensor(C.indptr, C.indices, C.values, C.shape,
                                        check_invariants=False)
        y_csr = spmv.csr_matvec(C, x)
        torch.cuda.synchronize()
        csr_rel = float((y_csr - y_plain).abs().max() / y_plain.abs().max())
        check(csr_rel <= 2e-6, f"K6 {tag}: the CSR product differs by {csr_rel:.3e}")
        # in turns: kernel, cuSPARSE, K3/K1, plain, then again
        ms, eager_ms = cuda_ms(lambda: spmv.sp_matvec(A, x))
        lib_ms, _ = cuda_ms(lambda: torch.mv(C_lib, x))
        csr_ms, _ = cuda_ms(lambda: spmv.csr_matvec(C, x))
        plain_ms, plain_eager_ms = cuda_ms(lambda: spmv.ell_matvec_plain(A, x))
        ms2, _ = cuda_ms(lambda: spmv.sp_matvec(A, x))
        lib_ms2, _ = cuda_ms(lambda: torch.mv(C_lib, x))
        csr_ms2, _ = cuda_ms(lambda: spmv.csr_matvec(C, x))
        vsize = 8 if dt == torch.float64 else 4
        nnz = int(C.values.numel())
        n_bytes, flops, layout = ell_cost(A, nnz, vsize)
        b_ms, b_by = bound_ms(n_bytes, flops, dt_name)
        layout_ms, _ = bound_ms(layout, flops, dt_name)
        max_err[dt_name] = max(max_err[dt_name], err)
        widths = A.widths()
        shapes[tag] = dict(
            rows=A.shape[0], cols=A.shape[1], dtype=dt_name, cap=A.cap, slices=A.n_slices,
            width_min=int(widths.min()), width_max=int(widths.max()),
            width_mean=float(widths.double().mean()), nnz=nnz,
            tail=int(A.tail_values.numel()), launches_a_product=sum(one_launch.values()),
            rel=rel, max_abs_err=err, ms=ms, ms_again=ms2, plain_ms=plain_ms,
            eager_ms=eager_ms, plain_eager_ms=plain_eager_ms, csr_kernel_ms=csr_ms,
            csr_kernel_ms_again=csr_ms2, library_ms=lib_ms, library_ms_again=lib_ms2,
            bytes=n_bytes, bound_ms=b_ms, bound_by=b_by,
            layout_bytes=layout, layout_bound_ms=layout_ms,
        )
        say("K6", f"{tag} {dt_name} {A.shape[0]}x{A.shape[1]} cap {A.cap}, {A.n_slices} slices "
            f"of width {int(widths.min())}-{int(widths.max())} (mean "
            f"{shapes[tag]['width_mean']:.2f}), nnz {nnz}, tail {shapes[tag]['tail']}: one "
            f"launch, rel {rel:.3e} max_abs {err:.3e} | device: kernel {ms:.5f} / {ms2:.5f} ms "
            f"cuSPARSE {lib_ms:.5f} / {lib_ms2:.5f} ms CSR kernel {csr_ms:.5f} / {csr_ms2:.5f} "
            f"ms plain {plain_ms:.5f} ms bound {b_ms:.5f} ms ({b_by}; the sliced layout's bytes "
            f"{layout} = {layout_ms:.5f} ms) | eager: kernel {eager_ms:.5f} ms "
            f"plain {plain_eager_ms:.5f} ms | {card}")
    return shapes, max_err


def k5_phase(torch, spmv, cases, device, card):
    """cases: {tag: (f32 CSR operator, its bf16 node blocks, its f32 node
    blocks, SweepAux)} -> records."""
    import numpy as np

    rng = np.random.default_rng(SEED + 5)
    shapes, max_err, bitwise = {}, 0.0, True
    for tag, (A, pk, B32, aux) in cases.items():
        n = A.shape[0]
        check(pk.block_values.dtype == torch.bfloat16 and torch.equal(pk.node_ptr, B32.node_ptr)
              and torch.equal(pk.block_cols, B32.block_cols)
              and torch.equal(pk.block_values, B32.block_values.to(torch.bfloat16)),
              f"K5 {tag}: the bf16 blocks do not round the f32 blocks of the level")
        widened = pk._replace(block_values=pk.block_values.to(torch.float32).contiguous())
        widened_csr = A._replace(values=A.values.to(torch.bfloat16).to(torch.float32))
        z = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
        r = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
        r = r * spmv.csr_matvec_plain(A, z).abs().max()
        n_fixed = int((aux.mask == 0).sum())
        check(n_fixed > 0, f"K5 {tag}: no constrained row in the operator")
        reps = 200 if n < 500_000 else 50  # the plain version allocates per call
        for update in (True, False):
            case = f"{tag}_{'update' if update else 'residual'}"
            got = spmv.block_jacobi_sweep_cuda(pk, aux, z, r, update)
            plain = spmv.node_block_sweep_plain(pk, aux, z, r, update)
            exp = spmv.block_jacobi_sweep_plain(widened_csr, aux, z, r, update)
            k4 = spmv.block_jacobi_sweep_cuda(widened, aux, z, r, update)
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"K5 {case}: not bitwise equal to the block plain version")
            err = float((got - exp).abs().max())
            rel = err / float(exp.abs().max())
            check(rel <= K5_TOL, f"K5 {case}: relative difference {rel:.3e} to the CSR plain")
            fixed = got[aux.mask == 0]
            want = z[aux.mask == 0] if update else torch.zeros_like(fixed)
            check(torch.equal(fixed, want), f"K5 {case}: constrained rows moved")
            check(torch.equal(got, spmv.block_jacobi_sweep_cuda(pk, aux, z, r, update)),
                  f"K5 {case}: not bitwise repeatable")
            same_k4 = torch.equal(got, k4)
            check(same_k4, f"K5 {case}: not bitwise equal to K4 on the widened values")
            ms, eager_ms = cuda_ms(lambda: spmv.block_jacobi_sweep_cuda(pk, aux, z, r, update))
            k4_ms, k4_eager_ms = cuda_ms(
                lambda: spmv.block_jacobi_sweep_cuda(B32, aux, z, r, update))
            plain_ms, plain_eager_ms = cuda_ms(
                lambda: spmv.node_block_sweep_plain(pk, aux, z, r, update), reps=reps)
            nnz, n_blocks = int(A.values.numel()), int(pk.block_cols.numel())
            csr_bytes, layout_bytes, flops = sweep_cost(n, nnz, n_blocks, 2, update)
            b_ms, b_by = bound_ms(layout_bytes, flops, "float32")
            csr_b_ms, _ = bound_ms(csr_bytes, flops, "float32")
            k4_bytes = sweep_cost(n, nnz, n_blocks, 4, update)[1]
            k4_b_ms, _ = bound_ms(k4_bytes, flops, "float32")
            max_err = max(max_err, err)
            bitwise = bitwise and same_k4
            shapes[case] = dict(
                rows=n, nnz=nnz, blocks=n_blocks, blocks_a_node=blocks_histogram(torch, pk),
                constrained_rows=n_fixed,
                update=update, rel=rel, max_abs_err=err, bitwise_equal_to_plain=True,
                bitwise_equal_to_k4_on_widened_values=same_k4, ms=ms, plain_ms=plain_ms,
                eager_ms=eager_ms, plain_eager_ms=plain_eager_ms, k4_f32_ms=k4_ms,
                k4_f32_eager_ms=k4_eager_ms, bytes=layout_bytes, bound_ms=b_ms, bound_by=b_by,
                csr_bytes=csr_bytes, csr_bound_ms=csr_b_ms, k4_f32_bound_ms=k4_b_ms,
            )
            say("K5", f"{case} {n} rows nnz {nnz} blocks {n_blocks}: bitwise equal to the block plain version and to K4 on the widened values, rel "
                f"{rel:.3e} max_abs {err:.3e} to the CSR plain, {n_fixed} constrained rows exact | "
                f"device: kernel {ms:.5f} ms, K4 on the f32 blocks {k4_ms:.5f} ms, plain "
                f"{plain_ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}; the layout's {layout_bytes} "
                f"bytes; K4's {k4_b_ms:.5f}), CSR bytes' bound {csr_b_ms:.5f} ms ({csr_bytes} "
                f"bytes) | eager: kernel {eager_ms:.5f} ms K4 {k4_eager_ms:.5f} ms plain "
                f"{plain_eager_ms:.5f} ms | {card}")
    return shapes, max_err, bitwise


def k7_matrices(torch, device):
    """{tag: (K (n, n) f32 on the card, b (n,) f32, f64 solve tolerance)}:
    the seeded SPD matrices of `tests/test_cholesky_pallas.py` at n = 128,
    200, 908 and 2000, the Jacobi-scaled tsx P1 elastic stiffness (908) and
    the footing's f32 elastic K_free (816), the matrix `FootingConfig.fast()`
    factors."""
    import numpy as np

    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes, lame_moduli
    from fem_elastoplasticity_tpu_torch.ops import assembly as asm
    from fem_elastoplasticity_tpu_torch.ops.elements import volume_element

    out = {}
    for n in K7_SIZES:
        rng = np.random.default_rng(n)
        A = rng.normal(size=(n, n))
        A = (A @ A.T + n * np.eye(n)).astype(np.float32)
        b = rng.normal(size=n).astype(np.float32)
        out[f"spd_{n}"] = (torch.as_tensor(A, device=device), torch.as_tensor(b, device=device),
                           K7_TOL_F64["spd"])

    def k_free(mesh, cfg, dtype):
        geom = asm.compute_geometry(torch.as_tensor(mesh.coords, device=device), mesh.elems,
                                    volume_element(mesh.etype)).to(dtype)
        D = elastic_tangent_lanes(*lame_moduli(cfg.young, cfg.poisson), geom.n_int, dtype, device)
        fmap, n_free = asm.free_dof_map(mesh.free)
        return asm.assemble_dense_free(asm.element_stiffness(geom, D),
                                       asm.dense_free_plan(geom, fmap, n_free))

    K = k_free(tsx.tsx_mesh(), TsxTunnelConfig(), torch.float64)
    d = torch.rsqrt(torch.diagonal(K))
    Ks = (K * d[:, None] * d[None, :]).to(torch.float32)
    out["tsx_scaled_908"] = (Ks, torch.ones(Ks.shape[0], device=device), K7_TOL_F64["fem"])
    cfg = FootingConfig.fast()
    Kf = k_free(footing.build_mesh(cfg), cfg, torch.float32)
    b = np.random.default_rng(SEED + 7).normal(size=Kf.shape[0]).astype(np.float32)
    out[f"footing_{Kf.shape[0]}"] = (Kf, torch.as_tensor(b, device=device), K7_TOL_F64["fem"])
    return out


def k7_phase(torch, chol, cases, per_factor, card):
    """cases: `k7_matrices`; per_factor: the kernels each case's
    factorization launched on the main run -> per-case records.  The factor's gap is
    max |L - L_plain| / max |L_plain|; the solve is held to the f64 solve
    (kernel factor and kernel solve) and, on the kernel's own factor, to
    the plain solve; cuSOLVER's `cholesky_ex` + `cholesky_solve` beside."""
    import numpy as np

    shapes = {}
    for tag, (K, b, tol64) in cases.items():
        n = K.shape[0]
        L, inv = chol.cholesky_factor_cuda(K)
        x = chol.cholesky_solve_cuda(L, inv, b, n)
        L_p, inv_p = chol.cholesky_factor_plain(K)
        x_on_kernel_factor = chol.cholesky_solve_plain(L, inv, b, n)
        x_plain = chol.cholesky_solve_plain(L_p, inv_p, b, n)
        L2, inv2 = chol.cholesky_factor_cuda(K)
        torch.cuda.synchronize()
        check(torch.equal(L, L2) and torch.equal(inv, inv2) and torch.equal(
            x, chol.cholesky_solve_cuda(L, inv, b, n)), f"K7 {tag}: not bitwise repeatable")
        check(bool(torch.isfinite(L).all() and torch.isfinite(x).all()), f"K7 {tag}: non-finite")
        check(torch.equal(torch.triu(L, 1), torch.zeros_like(L)), f"K7 {tag}: upper part not zero")
        err_L = float((L - L_p).abs().max())
        gap_L = err_L / float(L_p.abs().max())
        gap_inv = float((inv - inv_p).abs().max() / inv_p.abs().max())
        err_x = float((x - x_on_kernel_factor).abs().max())
        gap_solve = err_x / float(x_on_kernel_factor.abs().max())
        gap_end = float((x - x_plain).abs().max() / x_plain.abs().max())
        ref = np.linalg.solve(K.double().cpu().numpy(), b.double().cpu().numpy())
        gap64 = float(np.abs(x.double().cpu().numpy() - ref).max() / np.abs(ref).max())
        gap64_plain = float(np.abs(x_plain.double().cpu().numpy() - ref).max() / np.abs(ref).max())
        L_lib = torch.linalg.cholesky(K)
        x_lib = torch.cholesky_solve(b[:, None], L_lib)[:, 0]
        gap64_lib = float(np.abs(x_lib.double().cpu().numpy() - ref).max() / np.abs(ref).max())
        check(max(gap_L, gap_inv, gap_solve) <= K7_TOL,
              f"K7 {tag}: kernel against plain: factor {gap_L:.3e}, inverses {gap_inv:.3e}, "
              f"solve {gap_solve:.3e}")
        check(gap64 <= tol64, f"K7 {tag}: solve {gap64:.3e} from the f64 solve")
        reps = 20 if n <= 1000 else 10
        f_ms, f_eager = cuda_ms(lambda: chol.cholesky_factor_cuda(K), reps=reps)
        s_ms, s_eager = cuda_ms(lambda: chol.cholesky_solve_cuda(L, inv, b, n), reps=reps)
        fp_ms, fp_eager = cuda_ms(lambda: chol.cholesky_factor_plain(K), reps=2)
        sp_ms, sp_eager = cuda_ms(lambda: chol.cholesky_solve_plain(L, inv, b, n), reps=5)
        # the yardstick: cuSOLVER, the calls the dense paths make
        # (cholesky_ex: the same factor without the host read of its info)
        fl_ms, fl_eager = cuda_ms(lambda: torch.linalg.cholesky_ex(K), reps=reps)
        sl_ms, sl_eager = cuda_ms(lambda: torch.cholesky_solve(b[:, None], L_lib), reps=reps)
        n_pad = L.shape[0]
        fb_ms, fb_by = bound_ms(8 * n * n, n ** 3 / 3, "float32")
        # the solve reads, once, L below its diagonal blocks and the lower
        # triangles of the blocks' inverses: n (n + 1) / 2 entries within n,
        # a multiply-add each in each pass; b and x
        entries = n * (n + 1) // 2
        sb_ms, sb_by = bound_ms(4 * (entries + 2 * n), 4 * entries, "float32")
        shapes[tag] = dict(
            n=n, n_pad=n_pad, factor_kernel_launches=per_factor[tag],
            factor_gap=gap_L, inverse_gap=gap_inv, solve_gap_on_kernel_factor=gap_solve,
            solve_gap_end_to_end=gap_end, solve_gap_f64=gap64, plain_solve_gap_f64=gap64_plain,
            cusolver_solve_gap_f64=gap64_lib, factor_max_abs_err=err_L, solve_max_abs_err=err_x,
            factor_ms=f_ms, factor_eager_ms=f_eager, factor_plain_ms=fp_ms,
            factor_plain_eager_ms=fp_eager, factor_library_ms=fl_ms,
            factor_library_eager_ms=fl_eager, factor_bound_ms=fb_ms, factor_bound_by=fb_by,
            solve_ms=s_ms, solve_eager_ms=s_eager, solve_plain_ms=sp_ms,
            solve_plain_eager_ms=sp_eager, solve_library_ms=sl_ms,
            solve_library_eager_ms=sl_eager, solve_bound_ms=sb_ms, solve_bound_by=sb_by,
        )
        say("K7", f"{tag} n {n} (pad {n_pad}): factor gap {gap_L:.3e} (inverses {gap_inv:.3e}), "
            f"solve vs plain on the kernel's factor {gap_solve:.3e} (end to end {gap_end:.3e}), "
            f"vs f64 {gap64:.3e} (plain {gap64_plain:.3e}, cuSOLVER {gap64_lib:.3e}) | device: "
            f"factor {f_ms:.4f} ms plain {fp_ms:.3f} ms cuSOLVER {fl_ms:.4f} ms bound "
            f"{fb_ms:.5f} ms ({fb_by}); solve {s_ms:.4f} ms plain {sp_ms:.4f} ms cuSOLVER "
            f"{sl_ms:.4f} ms bound {sb_ms:.5f} ms ({sb_by}) | eager: factor {f_eager:.4f} ms "
            f"cuSOLVER {fl_eager:.4f} ms, solve {s_eager:.4f} ms cuSOLVER {sl_eager:.4f} ms "
            f"| {card}")
    return shapes


def footing_counts(r):
    return (r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic)


def jax_footing(name: str):
    """The JAX package's run from its fixture: (steps / Newton / CG /
    plastic, last accepted pressure, Newton iterations by load trip or None
    where the fixture has none)."""
    import numpy as np

    f = np.load(FIXTURES / f"{name}.npz")
    counts = tuple(int(f[k]) for k in ("n_steps", "n_newton_total", "n_cg_total", "n_plastic"))
    trips = tuple(int(k) for k in f["newton_trips"]) if "newton_trips" in f.files else None
    return counts, float(f["pressure_hist"][counts[0]]), trips


def check_newton(tag: str, r, cfg, want_total: int, jax_trips) -> None:
    """Newton iterations against the JAX run: by load trip where its
    fixture has them (`footing.newton_trip_gaps`: equal, or fewer on a trip
    at the two-float floor), else the total."""
    from fem_elastoplasticity_tpu_torch.models import footing

    if jax_trips is None:
        check(r.n_newton_total == want_total,
              f"{tag}: {r.n_newton_total} Newton iterations, JAX {want_total}")
        return
    bad = footing.newton_trip_gaps(r, jax_trips, cfg)
    check(not bad, f"{tag}: Newton by trip {r.newton_trips}, JAX {jax_trips}; trips off "
          f"(trip, port, JAX, last criterion) {bad}")


def check_footing_cg(tag: str, r, cfg, want: tuple, p_want: float, jax_trips,
                     p_tol: float) -> float:
    """Gate a truncated CG footing run against the JAX package's counts
    (steps / Newton / CG / plastic) and last pressure; returns the
    pressure's relative gap."""
    import numpy as np

    got = footing_counts(r)
    check(r.u.shape[1] == 2 and bool(np.isfinite(r.u).all() and np.isfinite(r.ep).all()),
          f"{tag}: bad field")
    check(got[0] == want[0] and got[3] == want[3], f"{tag}: counts {got}, JAX {want}")
    check_newton(tag, r, cfg, want[1], jax_trips)
    check(abs(got[2] - want[2]) <= 0.05 * want[2], f"{tag}: {got[2]} CG iterations, JAX {want[2]}")
    p = float(r.pressure_hist[r.n_steps])
    p_rel = abs(p - p_want) / p_want
    check(p_rel <= p_tol, f"{tag}: last pressure {p!r} is {p_rel:.3e} from JAX's {p_want!r}")
    return p_rel


SCALE_KERNELS = ("node_block_spmv", "node_transfer", "block_jacobi_sweep", "csr_spmv_f64")
ELL_KERNELS = ("ell_spmv_f32", "ell_spmv_f64")
FOOTING_ACG_KERNELS = ("node_block_spmv", "csr_spmv_f64")


def check_scale_launches(tag: str, launches: dict, kernels=SCALE_KERNELS) -> None:
    for name in kernels:
        check(launches.get(name, 0) > 0, f"{tag}: {name} never launched ({launches})")
    plain = {k: v for k, v in launches.items() if k.endswith("_plain") and v}
    check(not plain, f"{tag}: a plain version ran on the card ({plain})")
    # these paths keep no CSR operator: K3's CSR kernel runs only the footing
    # tangent multigrid's Galerkin value maps
    check(not launches.get("csr_spmv_f32"), f"{tag}: the CSR K3 launched ({launches})")
    if kernels == ELL_KERNELS:  # every operator is ELL: no CSR product, no side path
        csr = {k: v for k, v in launches.items() if k.startswith("csr_spmv") and v}
        check(not csr, f"{tag}: K3 / K1 launched for an ELL operator ({csr})")


# the footing's tangent-multigrid path: K1 (residual), K3's product (CG
# operator), transfers and CSR kernel (the Galerkin value maps), K4
FOOTING_SCALE_KERNELS = ("csr_spmv_f64", "node_block_spmv", "node_transfer",
                         "block_jacobi_sweep", "csr_spmv_f32")


def check_footing_scale_launches(tag: str, launches: dict, n_levels: int, n_newton: int,
                                 n_cg: int) -> None:
    """Every kernel of the path launched, no plain version; one CSR product
    a level below the fine one a Newton iteration (the Galerkin maps), and
    K3's product at least once a CG iteration."""
    for name in FOOTING_SCALE_KERNELS:
        check(launches.get(name, 0) > 0, f"{tag}: {name} never launched ({launches})")
    plain = {k: v for k, v in launches.items() if k.endswith("_plain") and v}
    check(not plain, f"{tag}: a plain version ran on the card ({plain})")
    check(launches["csr_spmv_f32"] == (n_levels - 1) * n_newton,
          f"{tag}: {launches['csr_spmv_f32']} Galerkin products for {n_newton} Newton "
          f"iterations on {n_levels} levels")
    check(launches["node_block_spmv"] >= n_cg,
          f"{tag}: fewer K3 products than CG iterations ({launches})")


def check_footing_scale(tag: str, r, cfg, name: str) -> dict:
    """Gate a fast_scale run against the JAX package's run of the same
    configuration (fixture `name`): steps equal, Newton iterations by trip
    (`footing.newton_trip_gaps`), CG within 5% in total, the accepted load
    factors within 1e-12 and the pressures within 1e-5.  Returns the gaps."""
    import numpy as np

    from fem_elastoplasticity_tpu_torch.models import footing

    f = np.load(FIXTURES / f"{name}.npz")
    check(bool(np.isfinite(r.u).all() and np.isfinite(r.ep).all()), f"{tag}: non-finite field")
    check(r.n_steps == int(f["n_steps"]), f"{tag}: {r.n_steps} steps, JAX {int(f['n_steps'])}")
    bad = footing.newton_trip_gaps(r, f["newton_trips"], cfg)
    check(not bad, f"{tag}: Newton by trip {r.newton_trips}, JAX {tuple(f['newton_trips'])}; "
          f"off {bad}")
    cg_jax = int(f["n_cg_total"])
    check(abs(r.n_cg_total - cg_jax) <= 0.05 * cg_jax, f"{tag}: {r.n_cg_total} CG, JAX {cg_jax}")
    zeta_gap = float(np.abs(np.asarray(r.zeta_trips) - f["zeta_trips"]).max())
    check(zeta_gap <= 1e-12, f"{tag}: accepted load factors {zeta_gap:.3e} from JAX's")
    n = r.n_steps + 1
    p_gap = float(np.abs(r.pressure_hist[1:n] - f["pressure_hist"][1:n]).max()
                  / np.abs(f["pressure_hist"][1:n]).max())
    check(p_gap <= 1e-5, f"{tag}: pressures {p_gap:.3e} from JAX's")
    return dict(jax=(int(f["n_steps"]), tuple(int(k) for k in f["newton_trips"]), cg_jax),
                zeta_gap=zeta_gap, pressure_gap=p_gap)


def refreshed_csr(spmv, host_K, blocks, device):
    """The f32 CSR of a refreshed level: its node-block values gathered at
    the positions of the level's CSR entries."""
    import numpy as np

    C = spmv.csr_to_device(host_K, device, np.float32)
    return C._replace(values=blocks.block_values.reshape(-1)[spmv.node_block_positions(C)])


def seeded_tangent(torch, n_int: int, shear: float, bulk: float, device):
    """A softened elastic tangent (3, 3, n_int), f32: SPD, other at every point."""
    import numpy as np

    from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes

    scale = 1.0 - 0.5 * np.random.default_rng(SEED + 9).random((1, 1, n_int))
    return elastic_tangent_lanes(shear, bulk, n_int, torch.float32, device) * torch.as_tensor(
        scale, dtype=torch.float32, device=device)


def footing_scale_phase(torch, spmv, mg, ex: dict, level: int, shear: float, bulk: float,
                        device, card):
    """The footing tangent multigrid's kernels at the shapes of its level-L
    build (`build_df32(..., extras=ex)`): K1 on the footing's G and S, K3's
    CSR kernel on every Galerkin value map, K3's product on the fine blocks
    refreshed from a seeded tangent and the hierarchy's transfers
    (`k3_phase`), K4 on every refreshed level (`k4_phase`), each against
    its plain version.  Returns (CSR records, their max abs error, K3
    records, K4 records, their max abs error)."""
    hier, th, host = ex["hierarchy"], ex["tangent"], ex["host_levels"]
    tag = f"footing_L{level}"
    ref = mg.refresh_hierarchy(th, hier, seeded_tangent(torch, th.geom.n_int, shear, bulk,
                                                        device), shear, bulk)
    G, S = ex["residual_op"]
    csr, csr_err = csr_phase(torch, spmv, {
        f"footing_G_L{level}": G, f"footing_S_L{level}": S,
        **{f"Mhat_L{level}_level{l + 1}to{l}": M for l, M in enumerate(th.mhat)}}, device, card)
    cases = k3_cases(spmv, hier, host, device, tag)
    cases[f"K_{tag}"] = (ref.levels[-1].op,
                         refreshed_csr(spmv, host[-1]["K"], ref.levels[-1].op, device),
                         None, False)
    k3 = k3_phase(torch, spmv, cases, device, card)
    k4, k4_err = k4_phase(torch, spmv, {
        f"{tag}_level{i}": (refreshed_csr(spmv, host[i]["K"], ref.levels[i].sweep_op, device),
                            ref.levels[i])
        for i in range(1, len(ref.levels))}, device, card)
    return csr, csr_err, k3, k4, k4_err


HIGH_ORDER_KERNELS = ("csr_spmv_f64", "csr_spmv_f32", "node_transfer", "block_jacobi_sweep")
# the P4 matrix-free df32 route's count at zeta 1/17 is not held: its one
# counted solve is the Newton step on the predictor's rounding residual and
# its count moves with the order of the f32 sums (tools/cg_order_spread.py,
# PERF.md); the route's CG is held on its plastic cut (tsx_p4_cg_z12)
HIGH_ORDER_CG_FREE = ("tsx_p4_cg_z1",)


def fixture_config(TsxTunnelConfig, ElementType, want):
    """The configuration of a high-order fixture's JAX run: its `config`
    (etype, the load steps of the cut, the route's keywords), which
    tools/make_port_fixtures.py stores with the run."""
    c = json.loads(want["config"].item())
    kw = {k: v for k, v in c.items() if k not in ("etype", "steps", "route")}
    return TsxTunnelConfig(etype=ElementType[c["etype"]], zeta_max=c["steps"] / 17, **kw)


def busy_line(busy, idle, n_kernels) -> str:
    if busy is None:
        return "device busy and idle share not measured (the profile lost the device's activity)"
    return f"device busy {busy:.4f} s, idle share {idle:.3f}, {n_kernels} kernels"


def df32_twice(torch, spmv, tsx, cfg, device):
    """Build `cfg` and run it twice: (TsxResult, LoadSteppingResult, setup s,
    first wall, warm wall, the first run's launches, extras, run, mesh),
    the two runs' counts and u held equal bit for bit."""
    extras = {}
    t0 = time.perf_counter()
    run, mesh = tsx.build_df32(cfg, device=device, extras=extras)
    torch.cuda.synchronize()
    setup = time.perf_counter() - t0
    spmv.LAUNCHES.clear()
    res1, first = timed(torch, run)
    launches = dict(spmv.LAUNCHES)
    res2, warm = timed(torch, run)
    counts = lambda r: (r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic)  # noqa: E731
    check(counts(res1) == counts(res2) and torch.equal(res1.u, res2.u),
          f"{cfg.etype.name} {cfg.solver}: two runs differ")
    r = tsx._df32_result(res1, mesh, extras)
    return r, res1, setup, first, warm, launches, extras, run, mesh


def check_no_plain(tag: str, launches: dict) -> None:
    check(not any(k.endswith("_plain") for k in launches),
          f"{tag}: a plain version ran on the card ({launches})")


def check_pmg_launches(tag: str, launches: dict, n_cg: int, gs: bool) -> None:
    """The p-multigrid route's kernels: K1 (residual), K3's CSR kernel (the
    f32 heads of G and S: the predictor, and with gs_tangent two a CG
    iteration), K3's transfers and K4 (the V-cycle); no plain version and
    no product of the P1 fine operator, which only preconditions."""
    for name in HIGH_ORDER_KERNELS:
        check(launches.get(name, 0) > 0, f"{tag}: {name} never launched ({launches})")
    check_no_plain(tag, launches)
    check("node_block_spmv" not in launches, f"{tag}: the P1 fine operator ran ({launches})")
    if gs:
        check(launches["csr_spmv_f32"] >= 2 * n_cg,
              f"{tag}: fewer than two K3 CSR launches a CG iteration ({launches})")


def high_order_run(torch, spmv, tsx, cfg, device, twice: bool):
    """Run a high-order route (native f64 through `solve`, df32 through
    `build_df32`), with `twice` a second time held bit-identical ->
    (TsxResult, LoadSteppingResult or None, the first run's launches,
    first wall, warm wall or None)."""
    import numpy as np

    tag = f"tsx {cfg.etype.name} {cfg.solver}"
    if cfg.precision != "native":
        if twice:
            r, res, _, first, warm, launches, _, _, _ = df32_twice(torch, spmv, tsx, cfg, device)
            return r, res, launches, first, warm
        run, mesh = tsx.build_df32(cfg, device=device, extras=(extras := {}))
        spmv.LAUNCHES.clear()
        res, first = timed(torch, run)
        return tsx._df32_result(res, mesh, extras), res, dict(spmv.LAUNCHES), first, None
    spmv.LAUNCHES.clear()
    r, first = timed(torch, lambda: tsx.solve(cfg, device=device))
    launches, warm = dict(spmv.LAUNCHES), None
    if twice:
        r2, warm = timed(torch, lambda: tsx.solve(cfg, device=device))
        check(np.array_equal(r.u, r2.u) and r.n_cg_total == r2.n_cg_total,
              f"{tag}: two runs differ")
    return r, None, launches, first, warm


def check_high_order(tag: str, cfg, r, res, launches: dict, want, hold_cg: bool) -> str:
    """A high-order run against a JAX run's fixture `want`: steps and
    plastic points equal, Newton iterations by trip (`check_newton`, df32)
    or in total (native), CG within 5% where `hold_cg` (the fixture is the
    same route's), u within 1e-9 of max |u|; the route's kernels launched
    and no plain version.  Returns the comparison for the phase's line."""
    import numpy as np

    jax_counts = tuple(int(want[k]) for k in ("n_steps", "n_newton_total", "n_cg_total",
                                             "n_plastic"))
    want_solver = json.loads(want["config"].item())["solver"]
    check(r.n_steps == jax_counts[0] and r.n_plastic == jax_counts[3],
          f"{tag}: steps / plastic {r.n_steps} / {r.n_plastic}, JAX {jax_counts}")
    if res is None:
        check_newton(tag, r, cfg, jax_counts[1], None)
        trips = "total"
    else:
        jax_trips = tuple(int(k) for k in want["newton_trips"])
        check_newton(tag, res, cfg, jax_counts[1], jax_trips)
        trips = f"{res.newton_trips} (JAX {jax_trips})"
    cg_gap = abs(r.n_cg_total - jax_counts[2]) / jax_counts[2]
    if hold_cg:
        check(cg_gap <= 0.05, f"{tag}: {r.n_cg_total} CG iterations, JAX {jax_counts[2]}")
    u_rel = float(np.abs(r.u - want["u"]).max() / np.abs(want["u"]).max())
    check(u_rel <= 1e-9, f"{tag}: u {u_rel:.3e} from JAX's")
    check_no_plain(tag, launches)
    if cfg.solver == "cg" and not cfg.assembled_cg:
        check(not launches, f"{tag}: launches {launches} on the matrix-free route")
    elif cfg.assembled_cg:
        check(launches.get("node_block_spmv", 0) >= r.n_cg_total
              and launches.get("csr_spmv_f64", 0) > 0, f"{tag}: launches {launches}")
    else:
        check_pmg_launches(tag, launches, r.n_cg_total, cfg.gs_tangent_on)
    cg_line = (f"CG {100 * cg_gap:.1f}% off, held to 5%" if hold_cg else
               "CG not compared" if cfg.solver != want_solver else
               f"CG {100 * cg_gap:.1f}% off, not held")
    return (f"steps / Newton / CG / plastic {(r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic)} "
            f"(JAX {jax_counts}; {cg_line}), Newton by trip {trips}, u {u_rel:.3e} "
            f"from JAX's, launches {launches}")


def high_order_route_phase(torch, spmv, tsx, TsxTunnelConfig, ElementType, device, card):
    """Phase 28: the P2 and P4 routes cut at the JAX fixtures' load steps
    (elastic), twice each, against the fixtures -> {route: launches}."""
    import numpy as np

    launches_by = {}
    for f in sorted(FIXTURES.glob("tsx_p2_*_z2.npz")) + sorted(FIXTURES.glob("tsx_p4_*_z1.npz")):
        want = np.load(f)
        cfg = fixture_config(TsxTunnelConfig, ElementType, want)
        tag = f"tsx {f.stem}"
        r, res, launches, first, warm = high_order_run(torch, spmv, tsx, cfg, device, True)
        line = check_high_order(tag, cfg, r, res, launches, want, f.stem not in HIGH_ORDER_CG_FREE)
        launches_by[f.stem] = launches
        say("high order", f"{tag}: {line}, repeat bit-identical, wall first {first:.3f} s warm "
            f"{warm:.3f} s | {card}")
    return launches_by


# phase 29 runs the p-multigrid routes only: the block-Jacobi ones (P2 at
# the full schedule, 38 s, and P4 cut at 12/17, 59 s, on an NVIDIA H100
# 80GB HBM3 at 700.00 W) made room for phases 34-36 and are held to their
# JAX runs by `python tools/high_order_plastic.py` on the card
PLASTIC_ROUTES = ("pmg_gs", "pmg_mf")


def high_order_plastic_phase(torch, spmv, tsx, TsxTunnelConfig, ElementType, device, card,
                             routes=PLASTIC_ROUTES):
    """Phase 29: the routes past the first plastic step (load step 11),
    once each: P2 at the full schedule against the JAX run of its own route
    (fixtures tsx_p2_*_z17), the routes of `routes` (all five:
    `tools/high_order_plastic.py`); with the block-Jacobi routes, P4 on the
    three cut at zeta 12/17 (tsx_p4_*_z12); the two P4 p-multigrid routes at
    12/17 against the JAX matrix-free df32 run (tsx_p4_cg_z12), CG not held
    (another preconditioner) -> {route: launches}."""
    import numpy as np

    launches_by = {}
    runs = [(f, None) for f in sorted(FIXTURES.glob("tsx_p2_*_z17.npz"))
            + sorted(FIXTURES.glob("tsx_p4_*_z12.npz"))
            if f.stem.split("_", 2)[2].rsplit("_", 1)[0] in routes]
    runs += [(FIXTURES / "tsx_p4_cg_z12.npz", gs) for gs in (True, False)]
    for f, gs in runs:
        want = np.load(f)
        cfg = fixture_config(TsxTunnelConfig, ElementType, want)
        name, tag = f.stem, f"tsx {f.stem}"
        if gs is not None:  # p-multigrid against the matrix-free df32 run
            cfg = TsxTunnelConfig.fast(etype=cfg.etype, zeta_max=cfg.zeta_max, solver="ell",
                                       gs_tangent=gs)
            name = f"tsx_p4_pmg_{'gs' if gs else 'mf'}_z12"
            tag = f"tsx {name} (against {f.stem})"
        r, res, launches, first, _ = high_order_run(torch, spmv, tsx, cfg, device, False)
        line = check_high_order(tag, cfg, r, res, launches, want, gs is None)
        check(r.n_plastic > 0 and r.n_newton_total > r.n_steps,
              f"{tag}: no plastic step ({r.n_plastic} plastic points)")
        launches_by[name] = launches
        say("high order plastic", f"{tag}: {line}, wall {first:.3f} s | {card}")
    return launches_by


# the ensemble's full width: the 8 x 8 (cohesion x friction) grid of
# benchmarks/ensemble_bench.py:24-26, cohesion-major; member 28, the grid
# point nearest the reference material (18.714, 48.57 deg), is swapped for
# the reference (18.7, 49 deg)
ENSEMBLE_REFERENCE = 28
# members held to their single solves' counts and u: the weakest (14, 40
# deg), the other corners, the reference and three inside the grid
ENSEMBLE_HELD = (0, 7, 56, 63, ENSEMBLE_REFERENCE, 9, 18, 45)
# u gates of a member against its single solve (tests/test_parallel.py):
# absolute for f64 and the dense df32, relative for f32 (its floor) and the
# df32 CG members
ENSEMBLE_U_GATES = {"f32": ("rel", 1e-5), "f64": ("abs", 1e-12), "df32": ("abs", 1e-15),
                    "df32_cg_L1": ("rel", 1e-14)}


def ensemble_grid(np):
    """(cohesions, friction angles, eta, c) of the 64 members."""
    from fem_elastoplasticity_tpu_torch.models.materials import drucker_prager_fit
    from fem_elastoplasticity_tpu_torch.parallel.ensemble import material_grid

    coh, fr = np.linspace(14, 25, 8), np.deg2rad(np.linspace(40, 55, 8))
    cc, ff = (a.ravel().copy() for a in np.meshgrid(coh, fr, indexing="ij"))
    eta, c = material_grid(coh, fr)
    cc[ENSEMBLE_REFERENCE], ff[ENSEMBLE_REFERENCE] = 18.7, 49.0 * np.pi / 180.0
    eta[ENSEMBLE_REFERENCE], c[ENSEMBLE_REFERENCE] = drucker_prager_fit(18.7, 49.0 * np.pi / 180.0)
    return cc, ff, eta, c


def k2_batched_phase(torch, rm, device, card):
    """Phase 32: K2's member-batched instance over the 64 members at the
    parity mesh's 896 points and refine 1's 3,584, f32 and f64, both
    plastic-strain modes and both apex modes: one launch's s, D, ind_p, lam
    and ep `torch.equal` to the batched plain version and to 64 single K2
    launches, two launches bit-identical; CUDA-event times beside the bytes
    bound, the 64 single launches and the launch floor."""
    import numpy as np

    from fem_elastoplasticity_tpu_torch.models.materials import lame_moduli

    shear, bulk = lame_moduli(60000.0, 0.2)
    _, _, eta, c = ensemble_grid(np)
    n_b = eta.size
    xf = torch.ones(896, dtype=torch.float32, device=device)
    yf = torch.empty_like(xf)
    floor_ms = cuda_ms(lambda: torch.neg(xf, out=yf), reps=100)[0]
    shapes, max_err = {}, 0.0
    for n in (896, 3584):
        rng = np.random.default_rng(SEED + 7 * n)
        e3_np = rng.normal(0, 2e-3, (n_b, 3, n))
        ep_np = rng.normal(0, 2e-4, (n_b, 4, n))
        e0_np = rng.normal(0, 1e-3, 4)
        zetas = np.float32(rng.integers(1, 18, n_b) / 17).astype(np.float64)
        params = torch.as_tensor(np.stack([eta, c, zetas], axis=1), device=device)
        for dt_name, dt in (("float32", torch.float32), ("float64", torch.float64)):
            e3 = torch.as_tensor(e3_np, dtype=dt, device=device)
            ep = torch.as_tensor(ep_np, dtype=dt, device=device)
            e0_dir = torch.as_tensor(e0_np, dtype=dt, device=device)
            for apply in (False, True):
                for apex in (False, True):
                    args = (e3, ep, shear, bulk, params, e0_dir, apply, apex)

                    def plain():
                        s, ds6, lam, ep_ = rm.dp_return_map_plain_batched(*args)
                        return s, rm.unpack_tangent(ds6), lam > 0.0, lam, ep_

                    def singles():
                        return [rm.dp_return_map_cuda(
                            e3[b], ep[b], shear, bulk, float(eta[b]), float(c[b]), e0_dir,
                            float(zetas[b]), apply, apex) for b in range(n_b)]

                    got = rm.dp_return_map_batched_cuda(*args)
                    again = rm.dp_return_map_batched_cuda(*args)
                    exp = plain()
                    one = singles()
                    torch.cuda.synchronize()
                    tag = (f"B{n_b}_n{n}_{dt_name}_{'ep' if apply else 'noep'}"
                           f"{'_trial' if apex else ''}")
                    ind = got[2]
                    apex_pts = ind & (got[1] == 0).all(dim=1).all(dim=1)
                    n_plastic, n_apex = int(ind.sum()), int(apex_pts.sum())
                    check(0 < n_apex < n_plastic < n_b * n, f"K2 batched {tag}: branches not "
                          f"all hit ({n_plastic} plastic, {n_apex} apex of {n_b * n})")
                    err = max(float((g - x).abs().max()) for g, x in zip(got, exp)
                              if x.dtype != torch.bool)
                    max_err = max(max_err, err)
                    check(all(torch.equal(g, x) for g, x in zip(got, exp)),
                          f"K2 batched {tag}: not bitwise the batched plain version")
                    check(all(torch.equal(g[b], o) for b in range(n_b)
                              for g, o in zip(got, one[b])),
                          f"K2 batched {tag}: not bitwise the {n_b} single launches")
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"K2 batched {tag}: two launches differ")
                    ms, eager_ms = cuda_ms(lambda: rm.dp_return_map_batched_cuda(*args),
                                           reps=100)
                    plain_ms = cuda_ms(plain, reps=10)[0]
                    singles_ms, singles_eager_ms = cuda_ms(singles, reps=10)
                    n_bytes = K2_BYTES_PER_POINT[dt_name] * n_b * n
                    b_ms, b_by = bound_ms(n_bytes, K2_FLOPS_PER_POINT * n_b * n, dt_name)
                    shapes[tag] = dict(
                        members=n_b, n=n, dtype=dt_name, apply_plastic_strain=apply,
                        apex_ep_uses_trial=apex, n_plastic=n_plastic, n_apex=n_apex,
                        bitwise_equal_to_plain=True, bitwise_equal_to_single_launches=True,
                        ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                        singles_ms=singles_ms, singles_eager_ms=singles_eager_ms,
                        launch_floor_ms=floor_ms, bytes=n_bytes, bound_ms=b_ms, bound_by=b_by,
                    )
                    say("K2 batched", f"{tag}: {n_plastic} plastic / {n_apex} apex, bitwise the "
                        f"plain version and {n_b} single launches | device: one launch {ms:.5f} "
                        f"ms, {n_b} single launches {singles_ms:.5f} ms, plain {plain_ms:.5f} ms, "
                        f"bound {b_ms:.5f} ms ({b_by}, {n_bytes} bytes), launch floor "
                        f"{floor_ms:.5f} ms | eager: one launch {eager_ms:.5f} ms, {n_b} single "
                        f"launches {singles_eager_ms:.5f} ms | {card}")
    return shapes, max_err


def ensemble_runs(TsxTunnelConfig):
    """(tag, config, df32) of the four ensembles phase 33 runs."""
    return (
        ("f32", TsxTunnelConfig.fast_f32(), False),
        ("f64", TsxTunnelConfig(), False),
        ("df32", TsxTunnelConfig.fast(), True),
        ("df32_cg_L1", TsxTunnelConfig.fast(solver="cg", refine_levels=1), True),
    )


# the CG ensemble's single solves take ~8.5 s each on the card (about
# 10,000 CG iterations a solve): the smoke compares two members, the
# weakest and the reference (four before phase 39, eight of ENSEMBLE_HELD
# before phase 37, ten before phases 34-36), and times their sequence;
# tools/ensemble_phases.py --all-singles compares all 64.
# Its profile covers the first ENSEMBLE_CG_PROFILE_TRIPS load trips: the
# full schedule is ~700,000 kernels, too many events for the profiler in
# the smoke's time (four trips recorded 92,674 kernels, one 53,019)
ENSEMBLE_CG_SINGLES = (0, ENSEMBLE_REFERENCE)
ENSEMBLE_CG_PROFILE_TRIPS = 1
# the dense ensembles compare every fourth member and ENSEMBLE_HELD (22 of
# 64; the 64 single solves of the three take ~30 s on the card);
# tools/ensemble_phases.py --all-singles compares all 64
ENSEMBLE_DENSE_SINGLES = tuple(sorted(set(range(0, 64, 4)) | set(ENSEMBLE_HELD)))


def ensemble_phase(torch, tsx, TsxTunnelConfig, device, card, all_singles: bool = False):
    """Phase 33: the four 64-member ensembles at full schedule, each run
    twice and bit-identical, once more under torch.profiler (the CG
    ensemble over its first ENSEMBLE_CG_PROFILE_TRIPS load trips); each
    compared member's schedule against its single port solve (the same
    steps and last zeta: ENSEMBLE_DENSE_SINGLES' members on the dense runs,
    ENSEMBLE_CG_SINGLES' on the CG run, every member with `all_singles`),
    and at least 8 (every one of the CG run's), the weakest and the
    reference among them, also Newton- and plastic-equal with u within
    ENSEMBLE_U_GATES; the f32
    ensemble through K2's batched instance only.  Returns ({run: its
    numbers}, the f32 run's K2 launches, {run: its EnsembleResult})."""
    import dataclasses

    import numpy as np

    from fem_elastoplasticity_tpu_torch.ops import return_map as rm
    from fem_elastoplasticity_tpu_torch.parallel import ensemble as ens
    from fem_elastoplasticity_tpu_torch.solve import newton

    cc, ff, eta, c = ensemble_grid(np)
    n_b = eta.size
    out, k2_launches, results = {}, {}, {}
    for tag, cfg, df32 in ensemble_runs(TsxTunnelConfig):
        t_phase = time.perf_counter()
        entry = ens.solve_tsx_ensemble_df32 if df32 else ens.solve_tsx_ensemble
        cg = cfg.solver == "cg"

        def solve(cfg=cfg):
            return entry(eta, c, cfg, device=device)

        rm.LAUNCHES.clear()
        newton.ENSEMBLE_STATS.clear()
        e1, first = timed(torch, solve)
        launches, stats = dict(rm.LAUNCHES), dict(newton.ENSEMBLE_STATS)
        torch.cuda.reset_peak_memory_stats(device)
        e2, warm = timed(torch, solve)
        results[tag] = e1
        peak = torch.cuda.max_memory_allocated(device)
        check(all(np.array_equal(x, y) if isinstance(x, np.ndarray) else x == y
                  for x, y in zip(e1, e2)), f"ensemble {tag}: two runs differ")
        newton.ENSEMBLE_STATS.clear()
        prof_cfg = dataclasses.replace(cfg, max_trips=ENSEMBLE_CG_PROFILE_TRIPS) if cg else cfg
        busy, idle, n_kernels = idle_share(lambda: solve(prof_cfg))
        prof_stats = dict(newton.ENSEMBLE_STATS)
        if tag == "f32":
            k2_launches = launches
            check(launches.get("dp_return_map_batched", 0) > 0 and set(launches) == {
                "dp_return_map_batched"}, f"ensemble f32: K2 launches {launches}")
        else:
            check(not launches, f"ensemble {tag}: a K2 route ran ({launches})")
        members = (tuple(range(n_b)) if all_singles
                   else ENSEMBLE_CG_SINGLES if cg else ENSEMBLE_DENSE_SINGLES)
        t0 = time.perf_counter()
        singles = {k: tsx.solve(dataclasses.replace(cfg, cohesion=float(cc[k]),
                                                    friction_angle=float(ff[k])), device=device)
                   for k in members}
        torch.cuda.synchronize()
        serial = time.perf_counter() - t0
        kind, gate = ENSEMBLE_U_GATES[tag]
        same_end, held, moved = 0, [], []
        for k, r in singles.items():
            steps = int(e1.n_steps[k])
            if steps == r.n_steps and e1.zeta_hist[k, steps - 1] == r.zeta_hist[steps - 1]:
                same_end += 1
            du = float(np.abs(e1.u[k] - r.u).max())
            if kind == "rel":
                du /= float(np.abs(r.u).max())
            counts = (steps, int(e1.n_newton_total[k]), int(e1.n_plastic[k]))
            if counts == (r.n_steps, r.n_newton_total, r.n_plastic) and du <= gate:
                held.append(k)
            else:
                moved.append((k, counts, (r.n_steps, r.n_newton_total, r.n_plastic), du))
        check(same_end == len(singles), f"ensemble {tag}: {len(singles) - same_end} members "
              "end where their single solves do not")
        check(len(held) >= min(8, len(singles)) and {0, ENSEMBLE_REFERENCE} <= set(held),
              f"ensemble {tag}: members off their single solves: {moved[:12]}")
        sweeps = stats["sweeps"]
        out[tag] = dict(
            members=n_b, first_s=first, warm_s=warm, solves_per_s=n_b / warm,
            singles=len(singles), serial_s=serial,
            serial_64_s=serial * n_b / len(singles), busy_s=busy, idle_share=idle,
            profiled_trips=ENSEMBLE_CG_PROFILE_TRIPS if cg else None, kernels=n_kernels,
            sweeps=sweeps,
            kernels_per_sweep=None if n_kernels is None else n_kernels / prof_stats["sweeps"],
            host_reads_per_sweep=stats["host_reads"] / sweeps, peak_gib=peak / 2**30,
            steps=[int(e1.n_steps.min()), int(e1.n_steps.max())],
            newton=[int(e1.n_newton_total.min()), int(e1.n_newton_total.max())],
            plastic=[int(e1.n_plastic.min()), int(e1.n_plastic.max())],
            held=len(held), moved=[m[:3] for m in moved], k2_launches=launches,
            reference_u40=float(e1.u[ENSEMBLE_REFERENCE, 40, 0]),
            phase_s=time.perf_counter() - t_phase,
        )
        o = out[tag]
        serial_line = (f"{n_b} single solves in sequence {serial:.3f} s" if len(singles) == n_b
                       else f"{len(singles)} single solves in sequence {serial:.3f} s "
                       f"({o['serial_64_s']:.1f} s for {n_b} at that rate)")
        per_sweep = ("" if n_kernels is None
                     else f": {o['kernels_per_sweep']:.1f} kernels a sweep")
        prof_line = (f" (profiled over the first {ENSEMBLE_CG_PROFILE_TRIPS} load trips, "
                     f"{prof_stats['sweeps']} sweeps)" if cg else "")
        say("ensemble", f"{tag}: {n_b} members, steps {o['steps']}, Newton {o['newton']}, "
            f"plastic {o['plastic']}; repeat bit-identical; the {len(singles)} compared end "
            f"with their single solves' steps and last zeta; {len(held)} with equal steps / "
            f"Newton / plastic and u within {gate:g} ({kind}), the others "
            f"{o['moved']} | wall first {first:.4f} s warm {warm:.4f} s ({n_b / warm:.1f} "
            f"solves/s), {serial_line} | {busy_line(busy, idle, n_kernels)}{prof_line}"
            f"{per_sweep}; "
            f"{sweeps} sweeps, {o['host_reads_per_sweep']:.2f} host reads a sweep | K2 "
            f"{launches} | peak {peak / 2**30:.3f} GiB | phase {o['phase_s']:.1f} s | {card}")
    return out, k2_launches, results


FOOTING_ETYPES = ("Q1", "P2", "Q2")
# tests/test_footing.py:246-265: the assembled quads cut at zeta 0.05
# against the matrix-free CG: the last pressure, the first six; the smoke
# cuts them at 0.005 (Q2's pair took 203 s at 0.05, 107 s at 0.02 and
# 64.8 s at 0.01 on an NVIDIA H100 80GB HBM3 at 700.00 W): the first steps
# are the same steps
FOOTING_ACG_ZETA = 0.005
ANCHOR_U40_SUPPORT = -1.922609586e-03  # tests/test_tsx_tunnel.py:346-355
# the level-1 assembled runs of phase 34 by element type: Q1 twice, as
# "slot" and "rslot" (one CSR route, so also the repeat, held bitwise); Q2
# once (81 s a run on an NVIDIA H100 80GB HBM3 at 700.00 W; its "slot" /
# "rslot" pair is held bitwise at level 0 by tests/test_torch_gpu.py)
FOOTING_ACG_RUNS = {"Q1": ("slot", "rslot"), "Q2": ("slot",)}


def footing_etypes_phase(torch, spmv, footing, FootingConfig, ElementType, device, card):
    """Phase 34 -> ({run: launches}, {et: the level-1 assembled build's
    extras}).  See the module docstring."""
    import dataclasses

    import numpy as np

    ref = json.loads((FIXTURES / "footing_reference_by_etype.json").read_text())
    for et in FOOTING_ETYPES:
        cfg = FootingConfig(etype=ElementType[et], level=0, bug_compatible_apex=True)
        spmv.LAUNCHES.clear()
        r, wall = timed(torch, lambda: footing.solve(cfg, device=device))
        check_no_plain(f"footing {et} f64", dict(spmv.LAUNCHES))
        n, z, p = r.n_steps, np.asarray(ref[et]["zeta"]), np.asarray(ref[et]["pressure"])
        check(n == len(z) and np.array_equal(r.zeta_hist[1:n + 1], z),
              f"footing {et} f64: schedule {r.zeta_hist[1:n + 1]} is not the reference's")
        p_gap = float(np.abs(r.pressure_hist[1:n + 1] - p).max() / p.max())
        check(p_gap < 1e-11, f"footing {et} f64: pressures {p_gap:.3e} from the reference's")
        fcfg = dataclasses.replace(FootingConfig.fast(), etype=ElementType[et], level=0,
                                   bug_compatible_apex=True)
        spmv.LAUNCHES.clear()
        rf, fwall = timed(torch, lambda: footing.solve(fcfg, device=device))
        check_no_plain(f"footing {et} df32", dict(spmv.LAUNCHES))
        check(rf.n_steps == n and np.allclose(rf.zeta_hist[1:n + 1], z, rtol=1e-12, atol=0),
              f"footing {et} df32: {rf.n_steps} steps off the f64 schedule")
        u_rel = float(np.abs(rf.u - r.u).max() / np.abs(r.u).max())
        fp_gap = float(np.abs(rf.pressure_hist[1:n + 1] - r.pressure_hist[1:n + 1]).max()
                       / np.abs(r.pressure_hist[1:n + 1]).max())
        check(u_rel < 1e-9 and fp_gap < 1e-5,
              f"footing {et} df32: u {u_rel:.3e} / pressures {fp_gap:.3e} from the f64 run")
        say("footing etypes", f"{et} level 0 ({r.mesh.n_nodes} nodes): f64 {n} steps / "
            f"{r.n_newton_total} Newton, schedule equal to the reference's, pressures "
            f"{p_gap:.3e} from it, wall {wall:.3f} s; fast() {rf.n_steps} steps / "
            f"{rf.n_newton_total} Newton, u {u_rel:.3e} and pressures {fp_gap:.3e} from the "
            f"f64 run, wall {fwall:.3f} s | {card}")
    launches_by, extras_by = {}, {}
    for et, fmts in FOOTING_ACG_RUNS.items():
        kw = dict(etype=ElementType[et], level=1, zeta_max=FOOTING_ACG_ZETA, solver="cg")
        runs = {}
        for fmt in fmts:
            ex = {}
            run, _ = footing.build_df32(FootingConfig.fast(assembled_cg=True, residual_fmt=fmt,
                                                           **kw), device=device, extras=ex)
            spmv.LAUNCHES.clear()
            runs[fmt], wall = timed(torch, run)
            launches = dict(spmv.LAUNCHES)
            check_scale_launches(f"footing {et} acg {fmt}", launches, FOOTING_ACG_KERNELS)
            check(launches["node_block_spmv"] >= runs[fmt].n_cg_total,
                  f"footing {et} acg: fewer K3 products than CG iterations ({launches})")
            launches_by[f"footing_{et}_acg_{fmt}"] = launches
            extras_by[et] = ex
            say("footing etypes", f"{et} level 1 acg residual_fmt={fmt!r}: steps / Newton / CG "
                f"/ plastic {footing_counts(runs[fmt])}, launches {launches}, wall {wall:.3f} s "
                f"| {card}")
        a = runs["slot"]
        if "rslot" in runs:
            b = runs["rslot"]
            check(np.array_equal(a.u, b.u) and footing_counts(a) == footing_counts(b),
                  f"footing {et} acg: 'slot' and 'rslot' differ")
        spmv.LAUNCHES.clear()
        mf, wall = timed(torch, lambda: footing.solve(FootingConfig.fast(**kw), device=device))
        check(not spmv.LAUNCHES, f"footing {et} mf: launches {dict(spmv.LAUNCHES)}")
        p_a, p_m = float(a.pressure_hist[a.n_steps]), float(mf.pressure_hist[mf.n_steps])
        last = abs(p_a - p_m) / abs(p_m)
        n6 = min(a.n_steps, mf.n_steps, 6)
        first = float(np.abs(a.pressure_hist[1:n6 + 1] - mf.pressure_hist[1:n6 + 1]).max()
                      / np.abs(mf.pressure_hist[1:n6 + 1]).max())
        check(last < 5e-3 and first < 1e-5,
              f"footing {et} acg: last pressure {last:.3e}, first six {first:.3e} from mf's")
        same = "'slot' and 'rslot' bitwise equal" if "rslot" in runs else "'slot'"
        say("footing etypes", f"{et} level 1 cut at zeta {FOOTING_ACG_ZETA}: acg {same} (u "
            f"sha256 {u_digest(a.u)}), against matrix-free CG "
            f"{footing_counts(mf)} (wall {wall:.3f} s): last pressure {p_a:.9f} vs {p_m:.9f} "
            f"({last:.3e}), first {n6} within {first:.3e} | {card}")
    return launches_by, extras_by


def tsx_options_phase(torch, spmv, tsx, TsxTunnelConfig, ElementType, device, card,
                      v_counts: dict):
    """Phase 35 -> ({run: launches}, {tag: extras of builds phase 36
    reads}).  v_counts: the V-cycle's (steps, Newton, CG) at L1 and L4 from
    phases 14 and 16.  See the module docstring."""
    import tempfile

    import numpy as np

    launches_by, builds = {}, {}
    fx = lambda name: np.load(FIXTURES / f"{name}.npz")  # noqa: E731
    counts = lambda r: (r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic)  # noqa: E731

    def native(tag, cfg):
        spmv.LAUNCHES.clear()
        r, wall = timed(torch, lambda: tsx.solve(cfg, device=device))
        check_no_plain(tag, dict(spmv.LAUNCHES))
        check(bool(np.isfinite(r.u).all()), f"{tag}: non-finite field")
        return r, wall

    def against_fixture(tag, r, res, cfg, name, hold_cg=True):
        want = fx(name)
        check(r.n_steps == int(want["n_steps"]) and r.n_plastic == int(want["n_plastic"]),
              f"{tag}: steps / plastic {r.n_steps} / {r.n_plastic}, JAX "
              f"{int(want['n_steps'])} / {int(want['n_plastic'])}")
        if res is None:
            check_newton(tag, r, cfg, int(want["n_newton_total"]), None)
        else:
            check_newton(tag, res, cfg, int(want["n_newton_total"]),
                         tuple(int(k) for k in want["newton_trips"]))
        n_cg = int(want["n_cg_total"])
        if hold_cg:
            check(abs(r.n_cg_total - n_cg) <= 0.05 * n_cg, f"{tag}: {r.n_cg_total} CG, JAX {n_cg}")
        u_rel = float(np.abs(r.u - want["u"]).max() / np.abs(want["u"]).max())
        check(u_rel < 1e-9, f"{tag}: u {u_rel:.3e} from JAX's")
        return (f"JAX {int(want['n_steps'])} / {int(want['n_newton_total'])} / {n_cg} / "
                f"{int(want['n_plastic'])} (CG {'held to 5%' if hold_cg else 'not held'}), "
                f"u {u_rel:.3e} from JAX's")

    # the matrix-free multigrid, native f64, against the port's block-Jacobi CG
    mg, mg_wall = native("tsx mg f64", TsxTunnelConfig(solver="mg", refine_levels=1))
    cg, cg_wall = native("tsx cg f64 L1", TsxTunnelConfig(solver="cg", refine_levels=1))
    gap = float(np.abs(mg.u - cg.u).max())
    check(mg.n_steps == cg.n_steps == 17 and gap <= 1e-14,
          f"tsx mg f64: {mg.n_steps} steps, u {gap:.3e} from the cg run's")
    say("tsx options", f"TsxTunnelConfig(solver='mg', refine_levels=1): {counts(mg)} against "
        f"solver='cg' {counts(cg)}, u within {gap:.3e} (absolute), walls {mg_wall:.3f} / "
        f"{cg_wall:.3f} s | {card}")
    # the same in df32: the f32 hierarchy built once at setup
    r, res, setup, first, warm, launches, _, _, _ = df32_twice(
        torch, spmv, tsx, TsxTunnelConfig.fast(solver="mg", refine_levels=1), device)
    check_no_plain("tsx mg df32", launches)
    rel = abs(float(r.u[40, 0]) - ANCHOR_U40_SCALE_L1) / abs(ANCHOR_U40_SCALE_L1)
    check(r.n_steps == 17 and r.n_plastic == 20 and rel <= 1e-8,
          f"tsx mg df32: {counts(r)}, u40 {float(r.u[40, 0])!r} ({rel:.3e})")
    say("tsx options", f"fast(solver='mg', refine_levels=1): {counts(r)}, u40 "
        f"{float(r.u[40, 0]):.12e} (rel {rel:.3e}), repeat bit-identical, setup {setup:.2f} s, "
        f"walls {first:.3f} / {warm:.3f} s | {card}")
    # the support pressure
    sp, wall = native("tsx support P1", TsxTunnelConfig(solver="cg", support_pressure=2.0))
    line = against_fixture("tsx support P1", sp, None, TsxTunnelConfig(solver="cg"),
                           "tsx_support_p1")
    gap = abs(float(sp.u[40, 0]) - ANCHOR_U40_SUPPORT)
    check(sp.n_steps == 17 and gap < 1e-9, f"tsx support P1: u40 {float(sp.u[40, 0])!r}")
    say("tsx options", f"TsxTunnelConfig(solver='cg', support_pressure=2.0): {counts(sp)}, u40 "
        f"{float(sp.u[40, 0]):.12e} ({gap:.3e} from {ANCHOR_U40_SUPPORT}); {line}; wall "
        f"{wall:.3f} s | {card}")
    for et in ("P2", "P4"):
        kw = dict(etype=ElementType[et], solver="cg", zeta_max=2 / 17)
        r0, w0 = native(f"tsx {et} unsupported", TsxTunnelConfig(**kw))
        r1, w1 = native(f"tsx {et} supported", TsxTunnelConfig(support_pressure=3.0, **kw))
        check(abs(float(r1.u[40, 0])) < abs(float(r0.u[40, 0])),
              f"tsx {et} support: no less closure ({float(r1.u[40, 0])!r} against "
              f"{float(r0.u[40, 0])!r})")
        say("tsx options", f"{et} support_pressure=3.0 cut at 2/17: u40 {float(r1.u[40, 0]):.9e} "
            f"against {float(r0.u[40, 0]):.9e} unsupported, walls {w1:.3f} / {w0:.3f} s | {card}")
    # the W-cycle
    for level in (1, 4):
        cfg = TsxTunnelConfig.fast_scale(level, mg_cycle="w")
        r, res, setup, first, warm, launches, ex, _, _ = df32_twice(torch, spmv, tsx, cfg, device)
        check_scale_launches(f"tsx W L{level}", launches)
        launches_by[f"scale_W_L{level}"] = launches
        if level == 1:
            line = against_fixture("tsx W L1", r, res, cfg, "tsx_scale_l1_w")
        else:
            rel = abs(float(r.u[40, 0]) - ANCHOR_U40_SCALE_L4) / abs(ANCHOR_U40_SCALE_L4)
            check(r.n_steps == 17 and rel <= 1e-6, f"tsx W L4: {counts(r)}, u40 rel {rel:.3e}")
            line = f"u40 {float(r.u[40, 0]):.9e} (rel {rel:.3e} to {ANCHOR_U40_SCALE_L4})"
            builds["W_L4"] = ex
        v = v_counts[level]
        per_cg = {k: round(launches.get(k, 0) / max(r.n_cg_total, 1), 2)
                  for k in ("block_jacobi_sweep", "node_transfer")}
        say("tsx options", f"fast_scale({level}, mg_cycle='w'): {counts(r)} against the V-cycle's "
            f"{v} (steps / Newton / CG / plastic); {line}; launches {launches} ({per_cg} a CG "
            f"iteration), repeat bit-identical, setup {setup:.2f} s, walls {first:.3f} / "
            f"{warm:.3f} s | {card}")
    # the deflated CG
    for name, cfg, hold in (
            ("tsx_scale_l1_defl4_z3", TsxTunnelConfig.fast_scale(1, cg_deflate=4,
                                                                 zeta_max=3 / 17), False),
            ("tsx_scale_l1_defl4", TsxTunnelConfig.fast_scale(1, cg_deflate=4), True)):
        r, res, setup, first, warm, launches, _, _, _ = df32_twice(torch, spmv, tsx, cfg, device)
        check_scale_launches(f"tsx {name}", launches)
        launches_by[name] = launches
        line = against_fixture(f"tsx {name}", r, res, cfg, name, hold_cg=hold)
        say("tsx options", f"{name} (cg_deflate=4): {counts(r)}; {line}; repeat bit-identical, "
            f"walls {first:.3f} / {warm:.3f} s | {card}")
    # the fixed-trip CG loop
    runs = {}
    for structure in ("while", "scan"):
        cfg = TsxTunnelConfig.fast_scale(1, cg_maxiter=200, cg_structure=structure,
                                         zeta_max=3 / 17)
        run, _ = tsx.build_df32(cfg, device=device)
        spmv.LAUNCHES.clear()
        runs[structure], wall = timed(torch, run)
        check_no_plain(f"tsx {structure}", dict(spmv.LAUNCHES))
        launches_by[f"scale_L1_{structure}_z3"] = dict(spmv.LAUNCHES)
        say("tsx options", f"fast_scale(1, cg_maxiter=200, cg_structure={structure!r}) cut at "
            f"3/17: {counts(runs[structure])}, launches {dict(spmv.LAUNCHES)}, wall {wall:.3f} s "
            f"| {card}")
    w, sc = runs["while"], runs["scan"]
    check(counts(w) == counts(sc) and torch.equal(w.u, sc.u),
          "tsx scan: not bitwise the while run")
    # P2 p-multigrid on ELL residual operators against the CSR route
    ell_cfg = TsxTunnelConfig.fast(etype=ElementType.P2, solver="ell", residual_fmt="ell",
                                   zeta_max=2 / 17)
    re_, res_e, _, first, _, l_ell, ex_ell, _, _ = df32_twice(torch, spmv, tsx, ell_cfg, device)
    check_scale_launches("tsx P2 ELL residual", l_ell, ELL_KERNELS)
    launches_by["p2_res_ell_z2"] = l_ell
    builds["P2_ell"] = ex_ell
    rc, res_c, _, _, _, l_csr, ex_csr, _, _ = df32_twice(
        torch, spmv, tsx, TsxTunnelConfig.fast(etype=ElementType.P2, solver="ell",
                                               gs_tangent=False, zeta_max=2 / 17), device)
    builds["P2_csr"] = ex_csr
    u_rel = float(np.abs(re_.u - rc.u).max() / np.abs(rc.u).max())
    check(re_.n_steps == rc.n_steps and res_e.newton_trips == res_c.newton_trips
          and u_rel < 1e-9, f"tsx P2 ELL residual: {counts(re_)} / {res_e.newton_trips}, CSR "
          f"route {counts(rc)} / {res_c.newton_trips}, u {u_rel:.3e}")
    say("tsx options", f"P2 p-multigrid on ELL G/S cut at 2/17: {counts(re_)} against the CSR "
        f"route's {counts(rc)}, Newton by trip {res_e.newton_trips}, u {u_rel:.3e} from it, "
        f"launches {l_ell} (CSR route {l_csr}), repeat bit-identical, wall {first:.3f} s | {card}")
    p4_ex = {}
    tsx.build_df32(TsxTunnelConfig.fast(etype=ElementType.P4, solver="ell", residual_fmt="ell",
                                        zeta_max=1 / 17), device=device, extras=p4_ex)
    p4_csr = {}
    tsx.build_df32(TsxTunnelConfig.fast(etype=ElementType.P4, solver="ell", zeta_max=1 / 17),
                   device=device, extras=p4_csr)
    builds["P4_ell"], builds["P4_csr"] = p4_ex, p4_csr
    # a chunked run, interrupted and finished from its checkpoint
    cfg = TsxTunnelConfig.fast_scale(1)
    single, _ = tsx.build_df32(cfg, device=device)
    full, _ = timed(torch, single)
    with tempfile.TemporaryDirectory() as tmp:
        ck = pathlib.Path(tmp) / "carry.npz"
        ex1, _ = tsx.build_df32_chunked(cfg, trips_per_chunk=3, max_chunks=2, device=device)
        part, w1 = timed(torch, lambda: ex1(checkpoint_path=ck))
        check(ck.exists() and part.n_steps < full.n_steps,
              f"tsx chunked: not interrupted ({part.n_steps} steps)")
        ex2, _ = tsx.build_df32_chunked(cfg, trips_per_chunk=3, device=device)
        spmv.LAUNCHES.clear()
        done, w2 = timed(torch, lambda: ex2(checkpoint_path=ck))
        launches_by["scale_L1_chunked"] = dict(spmv.LAUNCHES)
    check((done.n_steps, done.n_newton_total, done.n_cg_total)
          == (full.n_steps, full.n_newton_total, full.n_cg_total)
          and torch.equal(done.u, full.u), "tsx chunked: not bitwise the single run")
    say("tsx options", f"build_df32_chunked(fast_scale(1), trips_per_chunk=3, max_chunks=2) "
        f"stopped at step {part.n_steps} ({w1:.3f} s); a fresh executor finished from the "
        f"checkpoint ({w2:.3f} s): {done.n_steps} / {done.n_newton_total} / {done.n_cg_total}, "
        f"u bitwise the single run's | {card}")
    return launches_by, builds


def option_kernels_phase(torch, spmv, adf, footing, FootingConfig, footing_extras: dict,
                          builds: dict, device, card, ElementType, volume_element):
    """Phase 36 -> (CSR records, their max error, K3 records, K4 records,
    K4 max error, K6 records, K6 max errors).  See the module docstring."""
    import numpy as np

    from fem_elastoplasticity_tpu_torch.models.materials import lame_moduli

    fx = {}
    for et, ex in footing_extras.items():
        G, S = ex["residual_op"]
        fx[f"footing_G_{et}_L1"], fx[f"footing_S_{et}_L1"] = G, S
    csr, csr_err = csr_phase(torch, spmv, fx, device, card)
    shear, bulk = lame_moduli(FootingConfig().young, FootingConfig().poisson)
    k3 = {}
    for et in FOOTING_ETYPES:
        ex = footing_extras.get(et)
        if ex is None:  # P2: the operator of a build of its own
            ex = {}
            footing.build_df32(FootingConfig.fast(etype=ElementType[et], level=1, solver="cg",
                                                  assembled_cg=True), device=device, extras=ex)
        B, mesh = ex["elastic_op"], ex["solver_mesh"]
        K = spmv.build_elastic_csr(mesh.coords, mesh.elems, volume_element(ElementType[et]),
                                   shear, bulk, free=mesh.free)
        say("K3", f"footing {et} level-1 assembled elastic K: {B.n_nodes} nodes, "
            f"{B.block_cols.numel()} blocks, width {B.width}, blocks a node "
            f"{blocks_histogram(torch, B)} | {card}")
        k3[f"K_footing_{et}_L1"] = (B, spmv.csr_to_device(K, device, np.float32), None, False)
    k3_shapes = k3_phase(torch, spmv, k3, device, card)
    w4 = builds["W_L4"]
    levels = w4["hierarchy"].levels
    k4, k4_err = k4_phase(torch, spmv, {
        f"W_L4_level{i}": (spmv.csr_to_device(w4["host_levels"][i]["K"], device, np.float32),
                           levels[i]) for i in range(1, len(levels) - 1)}, device, card)
    k6 = {}
    for et in ("P2", "P4"):
        (Ge, Se), (Gc, Sc) = builds[f"{et}_ell"]["residual_op"], builds[f"{et}_csr"]["residual_op"]
        (Ge32, Se32), (Gc32, Sc32) = adf.f32_heads(Ge, Se), adf.f32_heads(Gc, Sc)
        k6.update({f"G_{et}_ell": (Ge, Gc), f"S_{et}_ell": (Se, Sc),
                   f"G32_{et}_ell": (Ge32, Gc32), f"S32_{et}_ell": (Se32, Sc32)})
    k6_shapes, k6_err = k6_phase(torch, spmv, k6, device, card)
    return csr, csr_err, k3_shapes, k4, k4_err, k6_shapes, k6_err


# phase 37: multi-device runs, N ranks on one card over gloo (every rank's
# tensors on cuda:0; NCCL refuses two ranks on one device).  The runs of one
# rank count share one spawn (`sharding.run_jobs`): a rank process takes
# ~8 s to reach the card.  The kernels of the sharded scale paths: K4's
# split-z instance in place of K4
SHARD_SCALE_KERNELS = ("node_block_spmv", "node_transfer", "block_jacobi_sweep_split",
                       "csr_spmv_f64")
# the footing's L2 tangent multigrid cut at zeta 0.004, over its first
# load trip: a gather takes ~7 ms at 8 ranks on one card; the whole cut (4
# trips, 9,512 gathers a rank) took 68 s, its first two trips 24.5 s
SHARD_FOOTING = dict(solver="cg", level=2, tangent_mg=True, zeta_max=0.004, max_trips=1)
# the member-sharded 64-member df32 ensemble against the one-card one:
# members batched with other members round their last bits another way
SHARD_ENSEMBLE_U_REL = 1e-12


def split_z_phase(torch, spmv, sharding, hier, host_levels, n_slices: int, device, card):
    """K4's split-z instance on every smoothed level of `hier` cut into
    n_slices row slices (`spmv.shard_rows`): each slice's launch bitwise its
    plain version and the unsharded launch's rows; CUDA-event times of the
    n_slices launches (one CUDA graph) beside the unsharded sweep, the
    plain versions and the bound (the whole sweep's bytes: the slices read
    each input once together).  Returns {case: record}."""
    import numpy as np

    rng = np.random.default_rng(SEED + 37)
    shapes = {}
    for li in range(1, len(hier.levels)):
        lev = hier.levels[li]
        B, aux = lev.sweep_op, lev.aux
        n = B.shape[0]
        z = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
        r = torch.as_tensor(rng.standard_normal(n).astype(np.float32), device=device)
        parts = [spmv.shard_rows(B, sharding.ShardGroup(k, n_slices, device, "gloo"))
                 for k in range(n_slices)]
        cut = []
        for p in parts:
            rows = slice(p.row0, p.row0 + p.rows)
            cut.append((p.local, spmv.SweepAux(*(a[rows] for a in aux)), r[rows]))
        for update in (True, False):
            case = f"L4_level{li}_x{n_slices}_{'update' if update else 'residual'}"
            whole = spmv.block_jacobi_sweep_cuda(B, aux, z, r, update)
            for p, (loc, aux_l, r_l) in zip(parts, cut):
                got = spmv.block_jacobi_sweep_cuda(loc, aux_l, z, r_l, update)
                plain = spmv.node_block_sweep_plain(loc, aux_l, z, r_l, update)
                torch.cuda.synchronize()
                check(torch.equal(got, plain), f"K4 split {case}: rank {p.group.rank} not "
                      "bitwise its plain version")
                check(torch.equal(got, whole[p.row0:p.row0 + p.rows]),
                      f"K4 split {case}: rank {p.group.rank} not the unsharded rows")

            def slices(update=update):
                for loc, aux_l, r_l in cut:
                    spmv.block_jacobi_sweep_cuda(loc, aux_l, z, r_l, update)

            def slices_plain(update=update):
                for loc, aux_l, r_l in cut:
                    spmv.node_block_sweep_plain(loc, aux_l, z, r_l, update)

            ms, eager_ms = cuda_ms(slices, reps=100)
            plain_ms, _ = cuda_ms(slices_plain, reps=20)
            whole_ms, _ = cuda_ms(lambda: spmv.block_jacobi_sweep_cuda(
                B, aux, z, r, update), reps=100)
            nnz = int(host_levels[li]["K"].nnz)
            _, layout_bytes, flops = sweep_cost(n, nnz, int(B.block_cols.numel()), 4, update)
            b_ms, b_by = bound_ms(layout_bytes, flops, "float32")
            shapes[case] = dict(rows=n, slices=n_slices, nodes=[p.local.n_nodes for p in parts],
                                ms=ms, eager_ms=eager_ms, plain_ms=plain_ms,
                                unsharded_ms=whole_ms, bound_ms=b_ms, bound_by=b_by,
                                bytes=layout_bytes, max_abs_err=0.0,
                                bitwise_equal_to_plain=True)
            say("K4 split", f"{case} {n} rows in {n_slices} slices of "
                f"{shapes[case]['nodes']} nodes: each launch bitwise its plain version and the "
                f"unsharded sweep's rows | device: {n_slices} launches {ms:.5f} ms, unsharded "
                f"{whole_ms:.5f} ms, plain {plain_ms:.5f} ms, bound {b_ms:.5f} ms ({b_by}) | "
                f"eager {eager_ms:.5f} ms | {card}")
    return shapes


def check_sharded_run(tag: str, m: dict, want_kernels=()) -> None:
    """A measured sharded run: its kernels launched (summed over the
    ranks), no plain version on the card."""
    for name in want_kernels:
        check(m["launches"].get(name, 0) > 0, f"{tag}: {name} never launched ({m['launches']})")
    plain = {k: v for k, v in m["launches"].items() if k.endswith("_plain") and v}
    check(not plain, f"{tag}: a plain version ran on the card ({plain})")


def sharded_phase(torch, spmv, tsx, footing, TsxTunnelConfig, FootingConfig, refs: dict,
                  device, card):
    """Phase 37: the multi-device layer, N ranks on the one card over gloo.

    Prints each rank's backend and device (gloo, cuda:0; no rank on the
    CPU, none with JAX loaded), then, one spawn a rank count: `solve_sharded`
    at 2 ranks over the full schedule (the single card's `solve(
    TsxTunnelConfig(solver="cg"))` steps and Newton iterations, u within
    1e-14); `solve_sharded_df32` at 2 ranks (1e-12 of max |u| from the
    single df32 CG solve, the same steps); the 64-member df32 parity
    ensemble at 2 ranks (32 members a rank) against phase 33's one-card
    ensemble (steps and Newton equal, u within SHARD_ENSEMBLE_U_REL
    relative); the dry run's four parts at 2 ranks (`dryrun_rank`, the JAX
    package's `dryrun_multichip`), held to `check_dryrun`'s gates, its two
    deflated row-sharded parts (`fast_scale(1, zeta_max=3/17,
    cg_deflate=4)`, the footing's level-3 tangent multigrid with
    cg_deflate=8 to zeta 0.002) bitwise their single-card runs;
    `solve_sharded_scale(fast_scale(1))` at 8 ranks and `fast_scale(4)` at
    2 ranks (4 ranks, a spawn of their own, before phase 39), each bitwise
    the single card's (the u digests of phases 14 and 17, the counts); the footing's tangent multigrid at L2, zeta 0.004
    (its first load trip), at 8 ranks, bitwise the single card's run.
    Walls (rank 0, between barriers), gathers and kernel launches (all
    ranks) of each; no profile (rank 0's device idle share per rank count:
    `tools/sharded_profile.py`).
    refs: the single-card results {"scale1": phase 14's TsxResult, "scale4":
    phase 17's, "ensemble_df32": phase 33's EnsembleResult}.  Returns
    (records, launches by path)."""
    import numpy as np

    from fem_elastoplasticity_tpu_torch.parallel import ensemble as ens
    from fem_elastoplasticity_tpu_torch.parallel import sharding

    counts = lambda r: (r.n_steps, r.n_newton_total, r.n_cg_total, r.n_plastic)  # noqa: E731
    # the single-card references this phase needs beside refs
    cg1, cg1_wall = timed(torch, lambda: tsx.solve(TsxTunnelConfig(solver="cg"), device=device))
    df1 = tsx.solve(TsxTunnelConfig.fast(solver="cg"), device=device)
    fcfg = FootingConfig.fast(**SHARD_FOOTING)
    run_f, _ = footing.build_df32(fcfg, device=device)
    f1, f1_wall = timed(torch, run_f)
    del run_f
    # the dry run's deflated row-sharded parts on the single card
    dry_cfg = sharding.dryrun_configs()
    ex_d = {}
    run_d, mesh_d = tsx.build_df32(dry_cfg["scale"][1], device=device, extras=ex_d)
    d1, d1_wall = timed(torch, run_d)
    d1 = tsx._df32_result(d1, mesh_d, ex_d)
    run_f, _ = footing.build_df32(dry_cfg["footing"][1], device=device)
    fd1, fd1_wall = timed(torch, run_f)
    del run_d, run_f, ex_d
    say("sharded", f"single-card references: tsx f64 CG {counts(cg1)} in {cg1_wall:.2f} s, "
        f"df32 CG {counts(df1)}, footing L2 tangent MG zeta 0.004 {f1.n_steps} / "
        f"{f1.n_newton_total} / {f1.n_cg_total} in {f1_wall:.2f} s, the dry run's "
        f"fast_scale(1) deflated {counts(d1)} in {d1_wall:.2f} s and footing L3 tangent MG "
        f"deflated {counts(fd1)} in {fd1_wall:.2f} s | {card}")
    _, _, eta, c = ensemble_grid(np)
    m = sharding.measured
    jobs = {
        2: [(sharding.describe, ()),
            (m, (tsx.solve_sharded_rank, (TsxTunnelConfig(),))),
            (m, (tsx.solve_sharded_df32_rank, (TsxTunnelConfig.fast(solver="cg"),))),
            (m, (ens.ensemble_rank, (eta, c, TsxTunnelConfig.fast()))),
            (m, (sharding.dryrun_rank, ())),
            # at 2 ranks since phase 39: a 4-rank spawn took 73-111 s
            (m, (tsx.solve_sharded_scale_rank, (TsxTunnelConfig.fast_scale(4),)))],
        8: [(sharding.describe, ()),
            (m, (tsx.solve_sharded_scale_rank, (TsxTunnelConfig.fast_scale(1),))),
            (m, (footing.solve_sharded_rank, (fcfg,)))],
    }
    out, launches, walls = {}, {}, {}
    for n, job in jobs.items():
        devices, backend = sharding.placement(n)
        t0 = time.perf_counter()
        res = sharding.spawn(sharding.run_jobs, n, job)
        walls[n] = time.perf_counter() - t0
        info, runs = res[0], res[1:]
        check([i[:3] for i in info] == [(k, backend, str(d)) for k, d in enumerate(devices)],
              f"sharded x{n}: ranks {info}, expected {backend} on {devices}")
        check(all(i[2].startswith("cuda") for i in info), f"sharded x{n}: a rank on the CPU")
        check(not any(i[4] for i in info), f"sharded x{n}: a rank loaded JAX ({info})")
        say("sharded", f"{n} ranks: backend {backend}, " + ", ".join(
            f"rank {i[0]} on {i[2]} ({i[3]})" for i in info) + f"; spawn {walls[n]:.1f} s, "
            f"runs " + ", ".join(f"{r['wall_s']:.2f}" for r in runs) + f" s | {card}")
        out[n] = runs

    # 2 ranks: the element-sharded solves, the member-sharded ensemble and
    # the dry run
    full, df2, ens2, dry, s4 = out[2]
    r = full["result"]
    du = float(np.abs(r.u - cg1.u).max())
    check((r.n_steps, r.n_newton_total) == (cg1.n_steps, cg1.n_newton_total) == (17, 28)
          and du <= 1e-14, f"solve_sharded x2: {counts(r)}, u {du:.3e} from the single card's "
          f"{counts(cg1)}")
    rd = df2["result"]
    ddf = float(np.abs(rd.u - df1.u).max()) / float(np.abs(df1.u).max())
    check(rd.n_steps == df1.n_steps and ddf <= 1e-12,
          f"solve_sharded_df32 x2: {counts(rd)}, u rel {ddf:.3e} from the single card's "
          f"{counts(df1)}")
    e2, e1 = ens2["result"], refs["ensemble_df32"]
    rel = np.abs(e2.u - e1.u).max(axis=(1, 2)) / np.abs(e1.u).max(axis=(1, 2))
    off = [(k, int(e2.n_steps[k]), int(e1.n_steps[k]), float(rel[k]))
           for k in range(e1.u.shape[0])
           if e2.n_steps[k] != e1.n_steps[k] or not rel[k] <= SHARD_ENSEMBLE_U_REL]
    check(not off, f"ensemble df32 x2: members off the one-card ensemble: {off}")
    # a member may part by its Newton count only where its criterion sits at
    # newton_tol (batched products round its last bits another way)
    forks = ens.member_forks(e2, e1, TsxTunnelConfig.fast().newton_tol)
    check(all(f[5] for f in forks), f"ensemble df32 x2: members part off newton_tol: {forks}")
    for tag, mm in (("solve_sharded x2", full), ("solve_sharded_df32 x2", df2),
                    ("ensemble df32 x2", ens2)):
        check_sharded_run(tag, mm)
    sharding.check_dryrun(dry["result"])
    ds, dfo = dry["result"]["scale"], dry["result"]["footing"]
    check(counts(ds) == counts(d1) and u_digest(ds.u) == u_digest(d1.u),
          f"dryrun x2 fast_scale(1) deflated: {counts(ds)} u {u_digest(ds.u)[:16]}, the single "
          f"card's {counts(d1)} u {u_digest(d1.u)[:16]}")
    check((dfo.n_steps, dfo.newton_trips, dfo.n_cg_total, dfo.n_plastic)
          == (fd1.n_steps, fd1.newton_trips, fd1.n_cg_total, fd1.n_plastic)
          and np.array_equal(dfo.u, fd1.u), f"dryrun x2 footing L3 deflated: {counts(dfo)}, "
          f"single card {counts(fd1)}, u equal {np.array_equal(dfo.u, fd1.u)}")
    check_sharded_run("dryrun x2", dry, SHARD_SCALE_KERNELS)
    # 2 and 8 ranks: the row-sharded scale paths, bitwise the single card
    s1 = out[8][0]
    for tag, mm, ref in (("fast_scale(4) x2", s4, refs["scale4"]),
                         ("fast_scale(1) x8", s1, refs["scale1"])):
        check(counts(mm["result"]) == counts(ref) and u_digest(mm["result"].u) == u_digest(ref.u),
              f"{tag}: {counts(mm['result'])} u {u_digest(mm['result'].u)[:16]}, the single "
              f"card's {counts(ref)} u {u_digest(ref.u)[:16]}")
        check_sharded_run(tag, mm, SHARD_SCALE_KERNELS)
    fm = out[8][1]
    rf = fm["result"]
    check((rf.n_steps, rf.newton_trips, rf.n_cg_total) == (f1.n_steps, f1.newton_trips,
                                                           f1.n_cg_total)
          and np.array_equal(rf.u, f1.u), f"footing tangent MG x8: {rf.n_steps} / "
          f"{rf.n_newton_total} / {rf.n_cg_total}, single card {f1.n_steps} / "
          f"{f1.n_newton_total} / {f1.n_cg_total}, u equal {np.array_equal(rf.u, f1.u)}")
    check_sharded_run("footing tangent MG x8", fm, SHARD_SCALE_KERNELS + ("csr_spmv_f32",))

    runs = {"solve_sharded_x2": (full, "17-step f64 CG"), "solve_sharded_df32_x2": (df2, "df32"),
            "ensemble_df32_x2": (ens2, "64 members"),
            "dryrun_x2": (dry, "four parts: f64, df32, scale L1 and footing L3 deflated"),
            "scale_L4_x2": (s4, "228,112 DOFs"),
            "scale_L1_x8": (s1, "3,678 DOFs"), "footing_tmg_L2_x8": (fm, "one trip")}
    records = {}
    for tag, (mm, what) in runs.items():
        res = mm["result"]
        if isinstance(res, dict):  # the dry run: counts by part
            cnt = {part: counts(v) for part, v in res.items()}
            kept = {part: [int(x) for x in v] for part, v in cnt.items()}
        else:
            cnt = counts(res) if hasattr(res, "n_cg_total") else None
            kept = None if cnt is None else [int(x) for x in cnt]
        idle = None if mm["busy_s"] is None else 1.0 - mm["busy_s"] / mm["wall_s"]
        records[tag] = dict(wall_s=mm["wall_s"], busy_s=mm["busy_s"], idle_share=idle,
                            counts=kept, launches=mm["launches"],
                            collectives=mm["collectives"])
        launches[f"sharded_{tag}"] = mm["launches"]
        busy = ("" if mm["busy_s"] is None
                else f", rank 0 device busy {mm['busy_s']:.4f} s, idle share {idle:.3f}")
        say("sharded", f"{tag} ({what}): wall {mm['wall_s']:.2f} s{busy}, counts {cnt}, "
            f"gathers {mm['collectives'].get('gathers', 0)} (all ranks), launches "
            f"{mm['launches']} | {card}")
    say("sharded", f"u within 1e-14 (x2 17 steps {du:.3e}), df32 rel "
        f"{ddf:.3e}, fast_scale(4) x2 and fast_scale(1) x8 u digests and counts the single "
        f"card's, footing x8 bitwise, the dry run's deflated parts x2 bitwise, ensemble x2 "
        f"max rel {float(rel.max()):.3e}, members "
        f"parting by their Newton count (member, trip, x2's, one card's, the criterion of the "
        f"one that stopped first, at newton_tol) {forks}; spawns "
        + ", ".join(f"x{n} {w:.1f} s" for n, w in walls.items()) + f" | {card}")
    return dict(runs=records, spawn_s=walls), launches


# phase 38: the side layers.  The bench preset's checkpoint splits its
# schedule where the JAX package's resume test does (tests/test_utils.py)
SIDE_SPLIT_ZETA = 8 / 17
# the example scripts, each with the figures its `--draw` makes
SIDE_EXAMPLES = (("elasticity2d_torch", 2), ("plasticity_dp_torch", 1), ("tsx_tunnel_torch", 3))


def load_example(name: str):
    """`examples/<name>.py` as a module, for its `main(argv)` in-process."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def check_example(name: str, res, out: str) -> None:
    """An example script's printout at its defaults against its anchor."""
    import numpy as np

    if name == "elasticity2d_torch":  # Q2 level 1
        energy = float(out.split("Stored energy: ")[1].split()[0])
        want = ELASTICITY_ANCHORS[("Q2", 1)]
        check(abs(energy - want) / want < 1e-10, f"{name}: energy {energy!r}, anchor {want}")
    elif name == "plasticity_dp_torch":  # P1 level 1, f64
        check(out.startswith("accepted steps: 16\n") and res.n_steps == 16
              and "Maximal load factor was achieved." in out, f"{name}: {out!r}")
        p_rel = float(np.abs(res.pressure_hist[1:17] - np.asarray(FOOTING_PRESSURES)).max()
                      / max(FOOTING_PRESSURES))
        check(p_rel <= 1e-4, f"{name}: pressures {p_rel:.3e} from the reference")
    else:  # the tsx, P1 f64
        u40 = float(out.split("u_x(node 40): ")[1].split()[0])
        rel = abs(u40 - ANCHOR_U40_F64) / abs(ANCHOR_U40_F64)
        check(out.startswith("accepted steps: 17\nNewton iterations: 28\n") and rel < 1e-9,
              f"{name}: {out!r}, u40 {rel:.3e} from the anchor")


def side_layers_phase(torch, spmv, tsx, TsxTunnelConfig, bench_digest: str, device, card):
    """Phase 38: the side layers on the card.

    The three example scripts (`examples/*_torch.py`) in-process at their
    defaults, each printing its anchor (`check_example`), with `--draw --figdir` under
    Agg where matplotlib is installed (each figure non-empty); the bench
    preset `TsxTunnelConfig.fast(assembled_cg=True)` run to zeta 8/17, its
    carry written through `utils.checkpoint.SolverCheckpoint`, read back and
    resumed to 1: 17 / 28 and u bitwise the uninterrupted run's (phase 7's
    digest), K1 launched and no plain version; `utils.timing`'s Timer,
    time_call and trace around the same preset, and `utils.metrics.log_run`
    on its result (17 step records).  Returns the split run's launches."""
    import contextlib
    import dataclasses
    import importlib.util
    import io
    import logging
    import tempfile

    from fem_elastoplasticity_tpu_torch.solve.newton import carry_of
    from fem_elastoplasticity_tpu_torch.utils import checkpoint as ckpt
    from fem_elastoplasticity_tpu_torch.utils import metrics, timing

    draw = importlib.util.find_spec("matplotlib") is not None
    if draw:
        import matplotlib

        matplotlib.use("Agg")
    with tempfile.TemporaryDirectory(prefix="side_layers_") as tmp:
        tmp = pathlib.Path(tmp)
        for name, n_figs in SIDE_EXAMPLES:
            argv = ["--draw", "--figdir", str(tmp / name)] if draw else []
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                res = load_example(name).main(argv)
            wall = time.perf_counter() - t0
            out = buf.getvalue()
            check_example(name, res, out)
            figs = "matplotlib is not installed: --draw not run"
            if draw:
                sizes = [f.stat().st_size for f in sorted((tmp / name).glob("*.png"))]
                check(len(sizes) == n_figs and all(sizes), f"{name}: figures {sizes}")
                figs = f"figures {sizes} bytes"
            say("side layers", f"{name} {' '.join(argv)} in {wall:.2f} s: "
                + " / ".join(" ".join(line.split()) for line in out.strip().splitlines())
                + f"; {figs} | {card}")

        # the bench preset split by a checkpoint file
        cfg = TsxTunnelConfig.fast(assembled_cg=True)
        run, _ = tsx.build_df32(cfg, device=device)
        run_a, _ = tsx.build_df32(dataclasses.replace(cfg, zeta_max=SIDE_SPLIT_ZETA),
                                  device=device)
        spmv.LAUNCHES.clear()
        t0 = time.perf_counter()
        part1 = run_a()
        path = tmp / "bench_split.npz"
        ckpt.save(str(path), ckpt.from_carry(carry_of(part1)))
        part2 = run(resume=ckpt.to_carry(ckpt.load(str(path)), device))
        torch.cuda.synchronize()
        split_wall = time.perf_counter() - t0
        split_launches = dict(spmv.LAUNCHES)
        r = tsx._df32_result(part2, None)
        check((int(part1.n_steps), r.n_steps, r.n_newton_total) == (8, 17, 28)
              and u_digest(r.u) == bench_digest,
              f"checkpoint: {int(part1.n_steps)} + {r.n_steps} steps / {r.n_newton_total} its, u "
              f"{u_digest(r.u)[:16]}, the uninterrupted run's {bench_digest[:16]}")
        check(split_launches.get("csr_spmv_f64", 0) > 0
              and not split_launches.get("csr_spmv_f64_plain", 0),
              f"checkpoint: launches {split_launches}")
        say("side layers", f"bench preset split at zeta 8/17 ({int(part1.n_steps)} steps) "
            f"through a SolverCheckpoint file ({path.stat().st_size} bytes) and resumed: "
            f"{r.n_steps} steps / {r.n_newton_total} its, u sha256 {u_digest(r.u)} (bitwise "
            f"the uninterrupted run's), launches {split_launches}, wall {split_wall:.3f} s "
            f"(both parts) | {card}")

        # utils.timing and utils.metrics around the same preset
        t = timing.Timer()
        for _ in range(3):
            with t.lap("bench") as box:
                box["sync"] = run()
        call_s = timing.time_call(run, reps=3, warmup=1)
        with timing.trace(str(tmp / "trace")):
            traced = run()
            timing.host_sync(traced)
        traces = list((tmp / "trace").glob("trace.*.json"))
        check(len(traces) == 1 and traces[0].stat().st_size > 0, f"trace: files {traces}")
        events = json.loads(traces[0].read_text()).get("traceEvents", [])
        n_kernels = sum(e.get("cat") == "kernel" for e in events)
        rb = tsx._df32_result(traced, None)
        check(u_digest(rb.u) == bench_digest, "timing: a timed run differs from phase 7's")
        records = []

        class Keep(logging.Handler):
            def emit(self, record):
                records.append(record.getMessage())

        keep, level = Keep(), metrics.log.level
        metrics.log.addHandler(keep)
        metrics.log.setLevel(logging.INFO)
        try:
            metrics.log_run(rb, monitor_name="u40")
        finally:
            metrics.log.removeHandler(keep)
            metrics.log.setLevel(level)
        n_steps = sum(m.startswith("step: ") for m in records)
        check(n_steps == 17 and any(m.startswith("run summary: ") and '"n_steps": 17' in m
                                    for m in records), f"metrics: {records[:2]}")
        say("side layers", f"bench preset: Timer laps {t.laps['bench']} s (median "
            f"{t.median('bench'):.4f}), time_call median {call_s:.4f} s, trace "
            f"{traces[0].stat().st_size} bytes with {len(events)} events, {n_kernels} of them "
            f"kernels, log_run {len(records)} records ({n_steps} steps) | {card}")
    return split_launches


# phase 39: the sweeps of fem_elastoplasticity_tpu_torch/benchmarks/.  The
# kernel function each launch name runs (the name torch.profiler records)
KERNEL_FUNCTIONS = {
    "csr_spmv_f64": "csr_spmv_kernel", "csr_spmv_f32": "csr_spmv_kernel",
    "node_block_spmv": "block_jacobi_sweep_kernel",
    "block_jacobi_sweep": "block_jacobi_sweep_kernel",
    "block_jacobi_sweep_bf16": "block_jacobi_sweep_kernel",
    "node_transfer": "node_transfer_kernel",
    "ell_spmv_f32": "sliced_ell_kernel", "ell_spmv_f64": "sliced_ell_kernel",
    "dp_return_map_batched": "dp_return_map_batched_kernel",
}
SLOT_KERNELS = ("node_block_spmv", "node_transfer", "block_jacobi_sweep")


class CutPresets:
    """A sweep module's TsxTunnelConfig for its profiled record: the fast
    presets cut after their first load step (every kernel of their routes
    runs in it)."""

    @staticmethod
    def fast(**kw):
        from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig

        return TsxTunnelConfig.fast(zeta_max=1 / 17, **kw)

    @staticmethod
    def fast_f32(**kw):
        from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig

        return TsxTunnelConfig.fast_f32(zeta_max=1 / 17, **kw)


def profiled_cut(torch, spmv, rm, tag: str, module, fn, kernels) -> str:
    """`profiled_sweep` of fn() with `module.TsxTunnelConfig` cut
    (`CutPresets`)."""
    full = module.TsxTunnelConfig
    module.TsxTunnelConfig = CutPresets
    try:
        return profiled_sweep(torch, spmv, rm, tag, fn, kernels)
    finally:
        module.TsxTunnelConfig = full


def sweep_launches(torch, spmv, rm, fn):
    """(fn(), the launches and plain-version calls of spmv and K2 it made)."""
    spmv.LAUNCHES.clear()
    rm.LAUNCHES.clear()
    out = fn()
    torch.cuda.synchronize()
    return out, {**spmv.LAUNCHES, **rm.LAUNCHES}


def check_sweep_kernels(tag: str, launches: dict, kernels) -> None:
    for name in kernels:
        check(launches.get(name, 0) > 0, f"{tag}: {name} never launched ({launches})")
    check_no_plain(tag, launches)


PROFILE_TRIES = 3


def profiled_sweep(torch, spmv, rm, tag: str, fn, kernels) -> str:
    """One record of a sweep under torch.profiler: its kernels launched
    (the launch counts of every try) and no plain version, and in the first
    of PROFILE_TRIES profiles that recorded the marker and every kernel
    function, the count of each.  torch.profiler can lose a session's
    device activity, or part of it: where every try lost some, the line
    says so and the launch counts stand alone."""
    funcs = sorted({KERNEL_FUNCTIONS[k] for k in kernels})
    lost = []
    for _ in range(PROFILE_TRIES):
        spmv.LAUNCHES.clear()
        rm.LAUNCHES.clear()
        events, wall = profiled_kernels(fn)
        check_sweep_kernels(f"{tag} (profiled)", {**spmv.LAUNCHES, **rm.LAUNCHES}, kernels)
        names = [] if events is None else [e.name for e in events]
        missing = [f for f in funcs if not any(f in n for n in names)]
        if events is not None and not missing:
            return (f"{tag}: {len(events)} kernels in {wall:.3f} s, "
                    + ", ".join(f"{f} x{sum(f in n for n in names)}" for f in funcs))
        lost.append("the device's activity" if events is None else f"{missing}")
    return (f"{tag}: not measured, every profile lost part of the device's activity "
            f"({'; '.join(lost)}); launch counts only")


def sweeps_phase(torch, spmv, rm, tsx, footing, TsxTunnelConfig, FootingConfig, refs: dict,
                 device, card):
    """Phase 39: every sweep of the port's `benchmarks/` in-process on the
    card at the sizes of the module docstring, under the earlier phases'
    gates.  refs: "scale1" phase 14's counts, "p4" phase 27's, "ensembles"
    phase 33's f32 and df32 EnsembleResults.  Returns {sweep: launches}."""
    import numpy as np

    from fem_elastoplasticity_tpu_torch.benchmarks import (
        assembly_sweep, dp_scale_bench, elastic_df32_sweep, elastic_ell_sweep, ensemble_bench,
        footing_scale_bench, p4_tsx_bench, solve_sweep, spmv_bench)
    from fem_elastoplasticity_tpu_torch.models.materials import elastic_tangent_lanes, lame_moduli
    from fem_elastoplasticity_tpu_torch.ops import assembly as asm
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element
    from fem_elastoplasticity_tpu_torch.solve.cg import solve_cg, stiffness_block_jacobi

    jax = json.loads((FIXTURES / "benchmark_sweeps.json").read_text())
    out, profiles, walls = {}, [], {}

    def record(name: str, rec) -> None:
        say("sweeps", f"{name} {json.dumps(rec)} | {card}")

    def run(name: str, fn):
        t0 = time.perf_counter()
        res, launches = sweep_launches(torch, spmv, rm, fn)
        walls[name] = time.perf_counter() - t0
        out[name] = launches
        for rec in (res if isinstance(res, list) else [res]):
            record(name, rec)
        return res

    # the elastic assembly pipeline, levels 0-5 (to 908,288 elements)
    recs = run("assembly", lambda: assembly_sweep.run_assembly_sweep(levels=5, verbose=False,
                                                                     device=device))
    check([r["n_elems"] for r in recs] == [887 * 4**k for k in range(6)]
          and recs[1]["n_dofs"] == jax["assembly"][1]["n_dofs"]
          and all(r["assemble_apply_s"] > 0 and np.isfinite(r["gdof_per_s"]) for r in recs),
          f"assembly sweep: {recs}")
    check(not out["assembly"], f"assembly sweep: a kernel ran ({out['assembly']})")

    # the elastic PCG solves (and one Newton iteration at levels 0-2)
    mg = run("solve_mg", lambda: solve_sweep.run_solve_sweep(
        levels=(0, 1, 2), reps=1, verbose=False, time_newton=True, device=device))
    mg += run("solve_mg_L3", lambda: solve_sweep.run_solve_sweep(levels=(3,), reps=1,
                                                                 verbose=False, device=device))
    jac = run("solve_jacobi", lambda: solve_sweep.run_solve_sweep(
        levels=(0, 1), reps=1, verbose=False, preconditioner="jacobi", device=device))
    check(mg[0]["n_dofs"] == 952 and abs(mg[0]["cg_iters"] - jax["solve_mg"]["cg_iters"]) <= 1
          and abs(jac[0]["cg_iters"] - jax["solve_jacobi"]["cg_iters"]) <= 1,
          f"solve sweep level 0: CG {mg[0]['cg_iters']} (mg), {jac[0]['cg_iters']} (jacobi); "
          f"JAX {jax['solve_mg']['cg_iters']}, {jax['solve_jacobi']['cg_iters']}")
    check(all(0 < r["cg_iters"] < 40 for r in mg) and all("newton_iter_s" in r for r in mg[:3]),
          f"solve sweep (mg): {mg}")

    # K6 against the matrix-free product, tsx L4 (228,112 DOFs)
    rec = run("spmv_bench", lambda: spmv_bench.main(4, device=device))
    check(rec["n_dofs"] == 228112 and rec["max_rel_diff"] <= K6_TOL["float32"],
          f"spmv_bench L4: {rec}")
    check_sweep_kernels("spmv_bench", out["spmv_bench"], ("ell_spmv_f32",))
    profiles.append(profiled_sweep(torch, spmv, rm, "spmv_bench L0",
                                   lambda: spmv_bench.main(0, reps=1, device=device),
                                   ("ell_spmv_f32",)))

    # the full scale-preset solves, levels 1-3
    dps = run("dp_scale", lambda: dp_scale_bench.run_dp_scale(reps=1, verbose=False,
                                                              device=device))
    l1 = dps[0]
    l1_counts = (l1["n_steps"], l1["n_newton_total"], l1["n_cg_total"], l1["n_plastic"])
    cg_jax = int(np.load(FIXTURES / "tsx_scale_l1.npz")["n_cg_total"])
    l1_rel = abs(l1["u40"] - ANCHOR_U40_SCALE_L1) / abs(ANCHOR_U40_SCALE_L1)
    check(l1_counts[:2] == (17, 37) and l1["n_plastic"] == 20 and l1_rel <= 1e-8
          and abs(l1["n_cg_total"] - cg_jax) <= 0.05 * cg_jax,
          f"dp_scale L1: {l1_counts}, u40 rel {l1_rel:.3e}, JAX CG {cg_jax}")
    check(l1_counts == refs["scale1"], f"dp_scale L1: {l1_counts}, phase 14 {refs['scale1']}")
    check(all(r["n_steps"] == 17 for r in dps), f"dp_scale: {dps}")
    check_sweep_kernels("dp_scale", out["dp_scale"], SCALE_KERNELS)
    profiles.append(profiled_sweep(
        torch, spmv, rm, "dp_scale L1 cut at 3/17",
        lambda: dp_scale_bench.run_dp_scale(levels=(1,), reps=0, verbose=False, device=device,
                                            zeta_max=3 / 17), SCALE_KERNELS))

    # the elastic df32 solves: matrix-free, then the assembled hierarchy
    dfs = run("elastic_df32", lambda: elastic_df32_sweep.run_elastic_df32_sweep(
        reps=1, verbose=False, device=device))
    cfg = TsxTunnelConfig()
    shear, bulk = lame_moduli(cfg.young, cfg.poisson)
    mesh1 = tsx.tsx_mesh(ElementType.P1, refine_levels=1)
    geom1 = asm.compute_geometry(torch.as_tensor(mesh1.coords, device=device), mesh1.elems,
                                 volume_element(ElementType.P1))
    s0 = torch.as_tensor(tsx.initial_state(cfg)[0][:3], device=device)
    D1 = elastic_tangent_lanes(shear, bulk, geom1.n_int, torch.float64, device)
    free1 = torch.as_tensor(mesh1.free, device=device)
    u64 = solve_cg(lambda v: asm.tangent_matvec(geom1, D1, v),
                   -asm.internal_force(geom1, s0[:, None].expand(3, geom1.n_int)), free1,
                   precond=stiffness_block_jacobi(geom1, D1, free1), tol=1e-14, maxiter=4000).x
    u64_max = float(u64.abs().max())
    df_rel = abs(dfs[1]["u_max"] - u64_max) / u64_max
    check(df_rel <= 1e-11, f"elastic_df32 L1: u_max {dfs[1]['u_max']!r} is {df_rel:.3e} from "
          f"the f64 CG solve's {u64_max!r}")
    slot = run("elastic_ell_slot", lambda: elastic_ell_sweep.run_elastic_ell_sweep(
        levels=(0, 1, 2, 3, 4), reps=1, verbose=False, device=device))
    ell = run("elastic_ell_ell", lambda: elastic_ell_sweep.run_elastic_ell_sweep(
        levels=(4,), reps=1, verbose=False, fmt="ell", device=device))
    slot_rel = abs(slot[1]["u_max"] - u64_max) / u64_max
    l4 = dfs[4]["u_max"]
    l4_rel = max(abs(slot[4]["u_max"] - l4), abs(ell[0]["u_max"] - l4)) / l4
    check(slot_rel <= 1e-11 and l4_rel <= 1e-9,
          f"elastic_ell: L1 u_max {slot_rel:.3e} from the f64 CG solve's, L4 slot / ell "
          f"{l4_rel:.3e} from the matrix-free sweep's")
    check_sweep_kernels("elastic_ell slot", out["elastic_ell_slot"], SLOT_KERNELS)
    check_scale_launches("elastic_ell slot", out["elastic_ell_slot"], SLOT_KERNELS)
    check_scale_launches("elastic_ell ell", out["elastic_ell_ell"], ("ell_spmv_f32",))
    check(set(out["elastic_ell_ell"]) == {"ell_spmv_f32"},
          f"elastic_ell ell: {out['elastic_ell_ell']}")
    for fmt in ("slot", "ell"):
        kernels = SLOT_KERNELS if fmt == "slot" else ("ell_spmv_f32",)
        profiles.append(profiled_sweep(
            torch, spmv, rm, f"elastic_ell {fmt} L1",
            lambda fmt=fmt: elastic_ell_sweep.run_elastic_ell_sweep(
                levels=(1,), reps=0, verbose=False, fmt=fmt, device=device), kernels))

    # the material ensembles: the 8 x 8 grid (f32 and df32), and 16 CG
    # members at refine 1 cut at 3/17
    ens = {}
    rec = run("ensemble", lambda: ensemble_bench.run_ensemble_bench(verbose=False, device=device,
                                                                     extras=ens))
    # the bench's grid is the JAX bench's: its member 28 is not phase 33's
    # reference material, so the batches differ and the other members may
    # round their last bits another way; every member's steps are held
    others = np.arange(ens["eta"].size) != ENSEMBLE_REFERENCE
    same = {}
    for tag in ("f32", "df32"):
        e, ref = ens[tag], refs["ensembles"][tag]
        check(np.array_equal(e.n_steps, ref.n_steps),
              f"ensemble_bench {tag}: steps {e.n_steps}, phase 33 {ref.n_steps}")
        counts = (e.n_newton_total == ref.n_newton_total) & (e.n_plastic == ref.n_plastic)
        same[tag] = (int(counts[others].sum()),
                     float(np.abs(e.u[others] - ref.u[others]).max()))
    check((rec["min_steps"], rec["max_steps"], rec["df32_min_steps"], rec["df32_max_steps"])
          == (17, 17, 17, 17), f"ensemble_bench: {rec}")
    check(set(out["ensemble"]) == {"dp_return_map_batched"},
          f"ensemble_bench: K2 launches {out['ensemble']}")
    say("sweeps", "ensemble_bench against phase 33 (the 63 members it shares): "
        + ", ".join(f"{tag} steps equal, {n} with equal Newton and plastic counts, u within "
                    f"{du:.3e}" for tag, (n, du) in same.items()) + f" | {card}")
    profiles.append(profiled_cut(
        torch, spmv, rm, "ensemble_bench 2 x 2 cut at 1/17", ensemble_bench,
        lambda: ensemble_bench.run_ensemble_bench(2, 2, verbose=False, device=device),
        ("dp_return_map_batched",)))
    ens_s = {}
    rec = run("ensemble_scale", lambda: ensemble_bench.run_ensemble_scale_bench(
        16, 1, zeta_max=3 / 17, verbose=False, device=device, extras=ens_s))
    check(rec["ensemble_size"] == 16 and (rec["min_steps"], rec["max_steps"]) == (3, 3)
          and bool(np.isfinite(ens_s["df32"].u).all()), f"ensemble_scale_bench: {rec}")
    check(not out["ensemble_scale"], f"ensemble_scale_bench: {out['ensemble_scale']}")

    # the footing: matrix-free CG at level 1 cut at zeta 0.02, then the
    # tangent-multigrid preset at level 2 over three load trips
    fx = {}
    # one run (reps=0): ~8 s on the card, the phase's longest
    f1, = run("footing_L1", lambda: footing_scale_bench.run_footing_scale(
        (1,), reps=0, verbose=False, device=device, extras=fx, zeta_max=0.02))
    want = jax["footing"]
    trips = np.load(FIXTURES / "footing_df32_cg_z002.npz")
    check((int(trips["n_steps"]), int(trips["n_newton_total"]), int(trips["n_cg_total"]))
          == (want["n_steps"], want["n_newton_total"], want["n_cg_total"]),
          "footing L1: the trip record is not the sweep's trajectory")
    gaps = footing.newton_trip_gaps(fx["results"][0], trips["newton_trips"], fx["configs"][0])
    p_rel = abs(f1["limit_pressure"] - want["limit_pressure"]) / want["limit_pressure"]
    check((f1["n_steps"], f1["n_plastic"]) == (want["n_steps"], want["n_plastic"]) and not gaps
          and abs(f1["n_cg_total"] - want["n_cg_total"]) <= 0.05 * want["n_cg_total"]
          and p_rel <= 1e-6,
          f"footing L1: {f1}, JAX {want}, Newton off by trip {gaps}, pressure {p_rel:.3e}")
    check(not out["footing_L1"], f"footing L1 (matrix-free): {out['footing_L1']}")
    fx2 = {}
    f2, = run("footing_scale_L2", lambda: footing_scale_bench.run_footing_scale(
        (2,), reps=1, verbose=False, scale_preset=True, device=device, extras=fx2, max_trips=3))
    r2 = fx2["results"][0]
    check_footing_scale("footing_scale_bench L2", r2, fx2["configs"][0], "footing_scale_l2_t3")
    check_footing_scale_launches("footing_scale_bench L2", out["footing_scale_L2"], 2,
                                 2 * r2.n_newton_total, 2 * r2.n_cg_total)
    profiles.append(profiled_sweep(
        torch, spmv, rm, "footing_scale_bench L2 one trip",
        lambda: footing_scale_bench.run_footing_scale(
            (2,), reps=0, verbose=False, scale_preset=True, device=device, max_trips=1),
        FOOTING_SCALE_KERNELS))

    # the reference's P4 configuration, full schedule
    p4 = run("p4_tsx", lambda: p4_tsx_bench.main(device=device))
    p4_counts = (p4["n_steps"], p4["n_newton_total"], p4["n_cg_total"], p4["n_plastic"])
    p4_rel = abs(p4["u40"] - ANCHOR_U40_P4) / abs(ANCHOR_U40_P4)
    check((p4["n_steps"], p4["n_newton_total"], p4["n_plastic"]) == JAX_COUNTS_P4
          and p4_rel <= 1e-6 and p4_counts == refs["p4"],
          f"p4_tsx_bench: {p4_counts}, phase 27 {refs['p4']}, u40 rel {p4_rel:.3e}")
    check_pmg_launches("p4_tsx_bench", out["p4_tsx"], 2 * p4["n_cg_total"], True)
    profiles.append(profiled_cut(torch, spmv, rm, "p4_tsx_bench cut at 1/17", p4_tsx_bench,
                                 lambda: p4_tsx_bench.main(device=device), HIGH_ORDER_KERNELS))

    for line in profiles:
        say("sweeps", f"profiled: {line} | {card}")
    say("sweeps", "walls (s): " + ", ".join(f"{k} {v:.1f}" for k, v in walls.items())
        + f"; launches {out} | {card}")
    return out


def ell_config(TsxTunnelConfig, level: int):
    return TsxTunnelConfig.fast_scale(level, spmv_fmt="ell", corr_mode="gather",
                                      residual_fmt="ell")


def main() -> int:
    import torch

    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible", file=sys.stderr)
        return 2
    import numpy as np

    from fem_elastoplasticity_tpu_torch.models import footing
    from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
    from fem_elastoplasticity_tpu_torch.models.config import FootingConfig, TsxTunnelConfig
    from fem_elastoplasticity_tpu_torch.ops import assembly as asm
    from fem_elastoplasticity_tpu_torch.ops import cholesky as chol
    from fem_elastoplasticity_tpu_torch.ops import return_map as rm
    from fem_elastoplasticity_tpu_torch.ops import spmv
    from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element
    from fem_elastoplasticity_tpu_torch.solve import newton
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

    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        futs = {name: pool.submit(build, load) for name, load in (
            ("csr_spmv", spmv.load_kernel), ("dp_return_map", rm.load_kernel),
            ("block_jacobi_sweep", spmv.load_sweep_kernel),
            ("node_transfer", spmv.load_transfer_kernel),
            ("ell_spmv", spmv.load_ell_kernel), ("cholesky_blocked", chol.load_kernel))}
        build_s = {name: f.result() for name, f in futs.items()}
    say("build", f"csr_spmv f64 and f32 (-fmad=false) {build_s['csr_spmv']:.2f} s, "
        f"dp_return_map (-fmad=false) {build_s['dp_return_map']:.2f} s, "
        f"block_jacobi_sweep with its bf16 instance and the "
        f"node-block product (-fmad=false) {build_s['block_jacobi_sweep']:.2f} s, "
        f"node_transfer (-fmad=false) {build_s['node_transfer']:.2f} s, ell_spmv f32 and f64 "
        f"(-fmad=false) {build_s['ell_spmv']:.2f} s, cholesky_blocked "
        f"{build_s['cholesky_blocked']:.2f} s, in parallel "
        f"(torch {torch.__version__}, CUDA {torch.version.cuda})")

    k1_shapes, k1_err = k1_phase(torch, spmv, tsx, asm, ElementType, volume_element, device, card)
    k2_shapes, k2_err, k2_bitwise = k2_phase(torch, rm, device, card)
    say("K2", f"kernel and plain version bitwise equal in every case: {k2_bitwise} | {card}")

    # phase 5: K7 through its entry points, on the matrices the dense paths
    # factor and the JAX package's test matrices; then each case against
    # the plain version and cuSOLVER
    k7_cases = k7_matrices(torch, device)
    chol.LAUNCHES.clear()
    k7_per_factor = {}  # the kernels each factorization launched, as the library reports
    for tag, (K, b, _) in k7_cases.items():
        before = chol.LAUNCHES["cholesky_factor"]
        L, inv = chol.cholesky_factor(K)
        k7_per_factor[tag] = chol.LAUNCHES["cholesky_factor"] - before
        chol.cholesky_solve(L, inv, b, K.shape[0])
    torch.cuda.synchronize()
    k7_launches = dict(chol.LAUNCHES)
    # one cooperative launch a factorization, whatever its panel count
    want_per_factor = {tag: 1 for tag in k7_cases}
    check(k7_per_factor == want_per_factor,
          f"K7: kernels a factorization {k7_per_factor}, expected {want_per_factor}")
    check(k7_launches == {"cholesky_factor": sum(want_per_factor.values()),
                          "cholesky_factorizations": len(k7_cases),
                          "cholesky_solve": len(k7_cases)}, f"K7: launches {k7_launches}")
    k7_shapes = k7_phase(torch, chol, k7_cases, k7_per_factor, card)

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
    bench_digest = u_digest(r1.u)
    field = float(abs(r1.u - r64.u).max() / abs(r64.u).max())
    check(field < 1e-11, f"bench: field differs from the f64 solve by {field:.3e}")
    say("bench", f"17 steps / 28 its, u40 rel {rel_df:.3e}, field vs f64 {field:.3e}, "
        f"K1 launches {launches.get('csr_spmv_f64', 0)}, "
        f"plain {launches.get('csr_spmv_f64_plain', 0)}, "
        f"repeat bit-identical, wall first {wall_first:.4f} s warm {wall_warm:.4f} s | {card}")

    # phase 8: tsx f32 through K2, one launch a return map of the Newton loop
    rm.LAUNCHES.clear()
    with CountCalls(newton, "dp_return_map_newton") as rm_tsx:
        t1, t_first = timed(torch, lambda: tsx.solve(TsxTunnelConfig.fast_f32(), device=device))
    k2_tsx = dict(rm.LAUNCHES)
    t2, t_warm = timed(torch, lambda: tsx.solve(TsxTunnelConfig.fast_f32(), device=device))
    check(k2_tsx.get("dp_return_map", 0) > 0, f"tsx f32: K2 never launched ({k2_tsx})")
    check(k2_tsx.get("dp_return_map_plain", 0) == 0, f"tsx f32: plain return map ran ({k2_tsx})")
    check(k2_tsx.get("dp_return_map", 0) == rm_tsx.calls,
          f"tsx f32: {rm_tsx.calls} return maps, K2 launches {k2_tsx}")
    check(bool(np.isfinite(t1.u).all()) and t1.u.shape == (476, 2), "tsx f32: bad field")
    check(t1.n_steps == 17, f"tsx f32: {t1.n_steps} steps")
    u40_rel = abs(float(t1.u[40, 0]) - ANCHOR_U40_F32) / abs(ANCHOR_U40_F32)
    check(u40_rel <= 1e-5, f"tsx f32: u40 {float(t1.u[40, 0])!r} is {u40_rel:.3e} from the anchor")
    check(counts(t1) == counts(t2), "tsx f32: two runs differ in their counts")
    check(np.array_equal(t1.u, t2.u), "tsx f32: two runs differ in u")
    f32_vs_f64 = abs(float(t1.u[40, 0]) - ANCHOR_U40_F64) / abs(ANCHOR_U40_F64)
    say("tsx f32", f"{t1.n_steps} steps / {t1.n_newton_total} its / {t1.n_plastic} plastic, "
        f"u40 {t1.u[40, 0]:.9e} (rel {u40_rel:.3e} to -1.979450e-03, {f32_vs_f64:.3e} to the "
        f"f64 anchor), K2 launches {k2_tsx.get('dp_return_map', 0)} for {rm_tsx.calls} return "
        f"maps, plain "
        f"{k2_tsx.get('dp_return_map_plain', 0)}, repeat bit-identical, wall first "
        f"{t_first:.4f} s warm {t_warm:.4f} s, u sha256 {u_digest(t1.u)} | {card}")

    # phase 9: footing f64, the parity anchor of the f32 and df32 runs
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

    # phase 10: footing f32 through K2, one launch a return map of the Newton loop
    rm.LAUNCHES.clear()
    with CountCalls(newton, "dp_return_map_newton") as rm_foot:
        g1, g_first = timed(torch, lambda: footing.solve(FootingConfig.fast_f32(), device=device))
    k2_foot = dict(rm.LAUNCHES)
    g2, g_warm = timed(torch, lambda: footing.solve(FootingConfig.fast_f32(), device=device))
    check(k2_foot.get("dp_return_map", 0) > 0, f"footing f32: K2 never launched ({k2_foot})")
    check(k2_foot.get("dp_return_map_plain", 0) == 0,
          f"footing f32: plain return map ran ({k2_foot})")
    check(k2_foot.get("dp_return_map", 0) == rm_foot.calls,
          f"footing f32: {rm_foot.calls} return maps, K2 launches {k2_foot}")
    check(bool(np.isfinite(g1.u).all()) and g1.u.shape == (441, 2), "footing f32: bad field")
    check(g1.zeta_hist[g1.n_steps] >= 1.0, f"footing f32: zeta ends at {float(g1.zeta_hist[g1.n_steps])!r}")
    p32, p64 = float(g1.pressure_hist[g1.n_steps]), float(f1.pressure_hist[16])
    lim_rel = abs(p32 - p64) / p64
    check(lim_rel <= 5e-4, f"footing f32: limit pressure {p32!r} is {lim_rel:.3e} from f64")
    check(counts(g1) == counts(g2), "footing f32: two runs differ in their counts")
    check(np.array_equal(g1.u, g2.u), "footing f32: two runs differ in u")
    say("footing f32", f"{g1.n_steps} steps / {g1.n_newton_total} its / {g1.n_plastic} plastic, "
        f"zeta {float(g1.zeta_hist[g1.n_steps])!r}, limit pressure {p32!r} (rel {lim_rel:.3e} to f64), "
        f"K2 launches {k2_foot.get('dp_return_map', 0)} for {rm_foot.calls} return maps, plain "
        f"{k2_foot.get('dp_return_map_plain', 0)}, repeat bit-identical, "
        f"wall first {g_first:.4f} s warm {g_warm:.4f} s, u sha256 {u_digest(g1.u)} | {card}")

    # phase 11: footing fast(), the dense df32 preset (cuSOLVER factors, the
    # matrix-free f64 residual: no hand-written kernel on this path)
    fd1, fd_first = timed(torch, lambda: footing.solve(FootingConfig.fast(), device=device))
    fd2, fd_warm = timed(torch, lambda: footing.solve(FootingConfig.fast(), device=device))
    check(fd1.u.shape == (441, 2) and bool(np.isfinite(fd1.u).all()), "footing df32: bad field")
    check(fd1.n_steps == 16, f"footing df32: {fd1.n_steps} steps")
    fd_zeta = float(np.abs(fd1.zeta_hist[1:17] / f1.zeta_hist[1:17] - 1.0).max())
    fd_u = float(np.abs(fd1.u - f1.u).max() / np.abs(f1.u).max())
    fd_p = float(np.abs(fd1.pressure_hist[1:17] - f1.pressure_hist[1:17]).max()
                 / np.abs(f1.pressure_hist[1:17]).max())
    check(fd_zeta <= 1e-6 and fd_u <= 1e-9 and fd_p <= 1e-5,
          f"footing df32: zeta {fd_zeta:.3e}, u {fd_u:.3e}, pressures {fd_p:.3e} from f64")
    check(footing_counts(fd1) == footing_counts(fd2) and np.array_equal(fd1.u, fd2.u),
          "footing df32: two runs differ")
    fd_jax, _, fd_jax_trips = jax_footing("footing_df32")
    check(footing_counts(fd1)[::3] == fd_jax[::3], f"footing df32: {footing_counts(fd1)}, JAX "
          f"{fd_jax}")
    check_newton("footing df32", fd1, FootingConfig.fast(), fd_jax[1], fd_jax_trips)
    say("footing df32", f"steps / Newton / CG / plastic {footing_counts(fd1)} (JAX package's "
        f"{fd_jax}; f64 run {f1.n_steps} / {f1.n_newton_total}), Newton by trip "
        f"{fd1.newton_trips} (JAX {fd_jax_trips}), against the f64 run: "
        f"zeta {fd_zeta:.3e}, u {fd_u:.3e}, pressures {fd_p:.3e}, repeat bit-identical, wall "
        f"first {fd_first:.4f} s warm {fd_warm:.4f} s | {card}")

    # phase 12: the footing's CG paths, truncated at zeta 0.02: matrix-free
    # block-Jacobi PCG in f64 and df32 (no hand-written kernel), and the
    # assembled full-tangent operator (K3 for every CG product, K1 for G/S)
    foot_cg = {  # tag: configuration, its fixture, the last pressure's tolerance
        "f64_cg_z002": (FootingConfig(solver="cg", zeta_max=0.02), "footing_cg_f64_z002", 1e-8),
        "df32_cg_z002": (FootingConfig.fast(solver="cg", zeta_max=0.02),
                         "footing_df32_cg_z002", 1e-6),
        "df32_acg_z002": (FootingConfig.fast(solver="cg", assembled_cg=True, cg_maxiter=4000,
                                             zeta_max=0.02), "footing_df32_acg_z002", 1e-6),
    }
    foot_launches, foot_res = {}, {}
    for tag, (fcfg, fixture, p_tol) in foot_cg.items():
        # each runs once (16-30 s a run): the df32 paths' repeats are held
        # bitwise by phases 11, 13 and the scale phases
        spmv.LAUNCHES.clear()
        c1, c_first = timed(torch, lambda: footing.solve(fcfg, device=device))
        foot_launches[tag] = dict(spmv.LAUNCHES)
        want, p_want, jax_trips = jax_footing(fixture)
        p_rel = check_footing_cg(f"footing {tag}", c1, fcfg, want, p_want, jax_trips, p_tol)
        if fcfg.assembled_cg:
            check_scale_launches(f"footing {tag}", foot_launches[tag], FOOTING_ACG_KERNELS)
            check(foot_launches[tag]["node_block_spmv"] >= c1.n_cg_total,
                  f"footing {tag}: fewer K3 launches than CG iterations")
        else:
            check(not foot_launches[tag], f"footing {tag}: launches {foot_launches[tag]}")
        foot_res[tag] = c1
        say(f"footing {tag}", f"steps / Newton / CG / plastic {footing_counts(c1)} (JAX "
            f"package's {want}), Newton by trip {c1.newton_trips} (JAX {jax_trips}), last "
            f"pressure {float(c1.pressure_hist[c1.n_steps])!r} (rel "
            f"{p_rel:.3e} to JAX's), launches {foot_launches[tag]}, wall {c_first:.3f} s, "
            f"{1e6 * c_first / c1.n_cg_total:.1f} us a CG iteration | {card}")
    ra, rf = foot_res["df32_acg_z002"], foot_res["df32_cg_z002"]
    check(ra.n_steps == rf.n_steps, "footing: the assembled and matrix-free schedules differ")
    acg_p = float(np.abs(ra.pressure_hist[1:ra.n_steps + 1] - rf.pressure_hist[1:rf.n_steps + 1]
                         ).max() / np.abs(rf.pressure_hist[1:rf.n_steps + 1]).max())
    check(acg_p <= 1e-6, f"footing: assembled pressures {acg_p:.3e} from the matrix-free run's")

    # phase 13: the assembled path at level 3 (13k unknowns), two load trips
    t0 = time.perf_counter()
    cfg3 = FootingConfig.fast(level=3, solver="cg", assembled_cg=True, cg_maxiter=4000,
                              max_trips=2)
    run3, mesh3 = footing.build_df32(cfg3, device=device)
    torch.cuda.synchronize()
    setup3 = time.perf_counter() - t0
    spmv.LAUNCHES.clear()
    g3a, h_first = timed(torch, run3)
    foot_launches["df32_acg_L3"] = dict(spmv.LAUNCHES)
    g3b, h_warm = timed(torch, run3)
    check(g3a.u.shape == (6561, 2), f"footing L3: shape {g3a.u.shape}")
    p3_rel = check_footing_cg("footing L3", g3a, cfg3, *JAX_FOOTING_ACG_L3, 1e-5)
    check(footing_counts(g3a) == footing_counts(g3b) and np.array_equal(g3a.u, g3b.u),
          "footing L3: two runs differ")
    check_scale_launches("footing L3", foot_launches["df32_acg_L3"], FOOTING_ACG_KERNELS)
    say("footing L3", f"setup {setup3:.3f} s; {mesh3.n_nodes} nodes, {mesh3.n_elems} elements, "
        f"{int(mesh3.free.sum())} unknowns; steps / Newton / CG / plastic {footing_counts(g3a)} "
        f"(JAX package's {JAX_FOOTING_ACG_L3[0]}), last pressure "
        f"{float(g3a.pressure_hist[g3a.n_steps])!r} (rel {p3_rel:.3e} to "
        f"{JAX_FOOTING_ACG_L3[1]}), launches {foot_launches['df32_acg_L3']}, repeat "
        f"bit-identical, wall first {h_first:.3f} s warm {h_warm:.3f} s | {card}")
    del run3, g3a, g3b

    # phase 14: the scale preset on the once-refined mesh, through solve()
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
        f"{s1.n_plastic} plastic, u40 {s1.u[40, 0]:.12e} (rel {l1_rel:.3e}), u sha256 "
        f"{u_digest(s1.u)}, launches {l1_launches}, wall {s1_wall:.3f} s (setup included) "
        f"| {card}")

    # phases 15-17: level 4, the full width of the scale path
    ex1, ex4 = {}, {}
    tsx.build_df32(TsxTunnelConfig.fast_scale(1), device=device, extras=ex1)
    t0 = time.perf_counter()
    run4, mesh4 = tsx.build_df32(TsxTunnelConfig.fast_scale(4), device=device, extras=ex4)
    torch.cuda.synchronize()
    setup4 = time.perf_counter() - t0
    fine4, fine1 = ex4["hierarchy"].levels[-1], ex1["hierarchy"].levels[-1]
    sizes = [lev.free.shape[0] for lev in ex4["hierarchy"].levels]
    say("scale L4", f"setup {setup4:.2f} s (host: hierarchy, G/S, refresh table); "
        f"{mesh4.n_nodes} nodes, {mesh4.n_elems} elements, hierarchy rows {sizes} | {card}")
    # the fine levels' f32 CSR (the hierarchy keeps none): K3's earlier
    # design and the CSR references of K4, K5 and K6
    csr4, csr1 = (spmv.csr_to_device(ex["host_levels"][-1]["K"], device, np.float32)
                  for ex in (ex4, ex1))
    k3_shapes = k3_phase(torch, spmv, {
        **k3_cases(spmv, ex4["hierarchy"], ex4["host_levels"], device, "L4"),
        **k3_cases(spmv, ex1["hierarchy"], ex1["host_levels"], device, "L1",
                   fine_only=True)}, device, card)
    k4_shapes, k4_err = k4_phase(
        torch, spmv, {"L4": (csr4, fine4), "L1": (csr1, fine1)}, device, card)

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
        f"{ANCHOR_U40_SCALE_L4}), u sha256 {u_digest(a1.u)}, launches {l4_launches}, "
        f"repeat bit-identical, "
        f"wall first {q_first:.3f} s warm {q_warm:.3f} s | {card}")

    # phases 18-19: the ELL format through K6, with the gather correction
    ex4e = {}
    t0 = time.perf_counter()
    run4e, mesh4e = tsx.build_df32(ell_config(TsxTunnelConfig, 4), device=device, extras=ex4e)
    torch.cuda.synchronize()
    setup4e = time.perf_counter() - t0
    fine4e = ex4e["hierarchy"].levels[-1]
    (G4e, S4e), (G4, S4) = ex4e["residual_op"], ex4["residual_op"]
    check(all(isinstance(op, spmv.EllMatrix) for op in (fine4e.op, fine4e.P, fine4e.R, G4e, S4e)),
          "scale ELL L4: an operator is not ELL")
    say("scale ELL L4", f"setup {setup4e:.2f} s; degree caps: fine operator {fine4e.op.cap}, "
        f"P {fine4e.P.cap}, R {fine4e.R.cap}, G {G4e.cap}, S {S4e.cap} | {card}")
    P4, R4 = (spmv.csr_to_device(A, device, np.float32)
              for A in host_transfers(ex4["host_levels"][-1]))
    k6_shapes, k6_err = k6_phase(torch, spmv, {
        "K_L4": (fine4e.op, csr4), "P_L4": (fine4e.P, P4), "R_L4": (fine4e.R, R4),
        "G_L4": (G4e, G4), "S_L4": (S4e, S4)}, device, card)

    spmv.LAUNCHES.clear()
    e1, e1_wall = timed(torch, lambda: tsx.solve(ell_config(TsxTunnelConfig, 1), device=device))
    e1_launches = dict(spmv.LAUNCHES)
    e1b = tsx.solve(ell_config(TsxTunnelConfig, 1), device=device)
    check(e1.u.shape == (1839, 2) and bool(np.isfinite(e1.u).all()), "scale ELL L1: bad field")
    check(e1.n_steps == 17 and e1.n_plastic == 20,
          f"scale ELL L1: {e1.n_steps} steps, {e1.n_plastic} plastic points")
    e1_rel = abs(float(e1.u[40, 0]) - ANCHOR_U40_SCALE_L1) / abs(ANCHOR_U40_SCALE_L1)
    check(e1_rel <= 1e-8, f"scale ELL L1: u40 {float(e1.u[40, 0])!r} is {e1_rel:.3e} from the anchor")
    check(counts4(e1) == counts4(e1b), "scale ELL L1: two runs differ in their counts")
    check(np.array_equal(e1.u, e1b.u), "scale ELL L1: two runs differ in u")
    check_scale_launches("scale ELL L1", e1_launches, ELL_KERNELS)
    say("scale ELL L1", f"steps / Newton / CG / plastic {counts4(e1)} (slot path {counts4(s1)}), "
        f"u40 {e1.u[40, 0]:.12e} (rel {e1_rel:.3e}), launches {e1_launches}, repeat "
        f"bit-identical, wall {e1_wall:.3f} s (setup included) | {card}")

    spmv.LAUNCHES.clear()
    p1, p_first = timed(torch, run4e)
    e4_launches = dict(spmv.LAUNCHES)
    p2, p_warm = timed(torch, run4e)
    c1, c2 = tsx._df32_result(p1, mesh4e, ex4e), tsx._df32_result(p2, mesh4e, ex4e)
    check(c1.u.shape == (114056, 2) and bool(np.isfinite(c1.u).all()), "scale ELL L4: bad field")
    check(c1.n_steps == 17, f"scale ELL L4: {c1.n_steps} steps")
    e4_rel = abs(float(c1.u[40, 0]) - ANCHOR_U40_SCALE_L4) / abs(ANCHOR_U40_SCALE_L4)
    check(e4_rel <= 1e-6, f"scale ELL L4: u40 {float(c1.u[40, 0])!r} is {e4_rel:.3e} from the anchor")
    check(counts4(c1) == counts4(c2), "scale ELL L4: two runs differ in their counts")
    check(torch.equal(p1.u, p2.u), "scale ELL L4: two runs differ in u")
    check_scale_launches("scale ELL L4", e4_launches, ELL_KERNELS)
    say("scale ELL L4", f"steps / Newton / CG / plastic {counts4(c1)} (slot path {counts4(a1)}), "
        f"u40 {c1.u[40, 0]:.9e} (rel {e4_rel:.3e}), launches {e4_launches}, repeat "
        f"bit-identical, wall first {p_first:.3f} s warm {p_warm:.3f} s (slot path "
        f"{q_first:.3f} / {q_warm:.3f} s) | {card}")
    del run4e, ex4e, fine4e, G4e, S4e, p1, p2

    # phases 20-21: level 5, its fine level smoothed from bf16 values (K5)
    ex5 = {}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    mem_before5 = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    run5, mesh5 = tsx.build_df32(TsxTunnelConfig.fast_scale(5), device=device, extras=ex5)
    torch.cuda.synchronize()
    setup5 = time.perf_counter() - t0
    levels5 = ex5["hierarchy"].levels
    sizes5 = [lev.free.shape[0] for lev in levels5]
    packed5 = [lev.sweep_op.block_values.dtype == torch.bfloat16 for lev in levels5]
    check(packed5 == [n >= 500_000 for n in sizes5] and packed5[-1],
          f"scale L5: packed levels {packed5} of rows {sizes5}")
    say("scale L5", f"setup {setup5:.2f} s (host: hierarchy, G/S, refresh table); "
        f"{mesh5.n_nodes} nodes, {mesh5.n_elems} elements, hierarchy rows {sizes5}, "
        f"packed {packed5} | {card}")
    fine5 = levels5[-1]
    check(fine5.op.block_values.dtype == torch.float32
          and fine5.op.node_ptr is fine5.sweep_op.node_ptr
          and fine5.op.block_cols is fine5.sweep_op.block_cols,
          "scale L5: the f32 product blocks do not share the bf16 blocks' structure")
    # the first solve's peak: setup, then one run, before the smoke's own
    # reference tensors of phases 15, 16 and 20
    spmv.LAUNCHES.clear()
    v1, v_first = timed(torch, run5)
    l5_launches = dict(spmv.LAUNCHES)
    peak5 = torch.cuda.max_memory_allocated() - mem_before5
    # K3 on the level-5 fine operator and every level's transfers, whose
    # launches the small levels dominate
    k3_shapes.update(k3_phase(
        torch, spmv, k3_cases(spmv, ex5["hierarchy"], ex5["host_levels"], device, "L5"),
        device, card))
    # K4 on every level it smooths at L5 (levels 1-4; level 0 is solved
    # directly, level 5 smoothed by K5), against the CSR of the host
    # hierarchy
    k4_l5, k4_l5_err = k4_phase(torch, spmv, {
        f"L5_level{i}": (spmv.csr_to_device(ex5["host_levels"][i]["K"], device, np.float32),
                         levels5[i])
        for i in range(1, len(levels5) - 1)}, device, card)
    k4_shapes.update(k4_l5)
    k4_err = max(k4_err, k4_l5_err)
    csr5 = spmv.csr_to_device(ex5["host_levels"][-1]["K"], device, np.float32)
    k5_shapes, k5_err, k5_bitwise = k5_phase(torch, spmv, {
        "L5": (csr5, fine5.sweep_op, fine5.op, fine5.aux),
        "L1": (csr1, spmv.node_blocks(csr1, torch.bfloat16), fine1.sweep_op, fine1.aux)},
        device, card)
    del csr5

    v2, v_warm = timed(torch, run5)
    b1, b2 = tsx._df32_result(v1, mesh5, ex5), tsx._df32_result(v2, mesh5, ex5)
    check(b1.u.shape == (mesh5.n_nodes, 2) and b1.ep.shape[0] == 4
          and b1.ep.shape[1] >= mesh5.n_elems, f"scale L5: shapes {b1.u.shape} {b1.ep.shape}")
    check(bool(np.isfinite(b1.u).all() and np.isfinite(b1.ep).all()), "scale L5: non-finite field")
    check(b1.n_steps == 17, f"scale L5: {b1.n_steps} steps")
    l5_rel = abs(float(b1.u[40, 0]) - ANCHOR_U40_SCALE_L5) / abs(ANCHOR_U40_SCALE_L5)
    check(l5_rel <= 1e-6, f"scale L5: u40 {float(b1.u[40, 0])!r} is {l5_rel:.3e} from the anchor")
    check(counts4(b1) == counts4(b2), "scale L5: two runs differ in their counts")
    check(torch.equal(v1.u, v2.u), "scale L5: two runs differ in u")
    check_scale_launches("scale L5", l5_launches, SCALE_KERNELS + ("block_jacobi_sweep_bf16",))
    # every V-cycle sweeps each level alike: K4's launches are K5's on each
    # of the four levels below the fine one
    k4_levels5 = len(levels5) - 2
    check(l5_launches["block_jacobi_sweep"] == k4_levels5 * l5_launches["block_jacobi_sweep_bf16"],
          f"scale L5: K4 launches not {k4_levels5} x K5's ({l5_launches})")
    # each V-cycle level above the coarsest runs one R and one P (four
    # sweeps, nu = 2): two transfers for every two sweeps
    n_sweeps = l5_launches["block_jacobi_sweep"] + l5_launches["block_jacobi_sweep_bf16"]
    check(2 * l5_launches["node_transfer"] == n_sweeps,
          f"scale L5: transfers not one R and one P a level of a V-cycle ({l5_launches})")
    say("scale L5", f"steps / Newton / CG / plastic {counts4(b1)} (JAX package's record "
        f"{JAX_COUNTS_SCALE_L5} steps / Newton / CG), u40 {b1.u[40, 0]:.9e} (rel {l5_rel:.3e} "
        f"to {ANCHOR_U40_SCALE_L5}), u sha256 {u_digest(b1.u)}, launches {l5_launches} (K4 "
        f"{l5_launches['block_jacobi_sweep_bf16']} on each of levels 1-{k4_levels5}), repeat "
        f"bit-identical, wall first "
        f"{v_first:.3f} s warm {v_warm:.3f} s, peak device memory of setup and first run "
        f"{peak5 / 2**30:.3f} GiB above the {mem_before5 / 2**30:.3f} GiB held before | "
        f"{card}")
    del run5, ex5, levels5, fine5, v1, v2, b1, b2

    # phase 22: the elasticity problem (no kernel on its path)
    from fem_elastoplasticity_tpu_torch.models import elasticity
    from fem_elastoplasticity_tpu_torch.models.config import ElasticityConfig
    from fem_elastoplasticity_tpu_torch.models.materials import lame_moduli
    from fem_elastoplasticity_tpu_torch.solve import multigrid as mg
    from fem_elastoplasticity_tpu_torch.utils.convert import load_checkpoint

    spmv.LAUNCHES.clear()
    el = {}
    for (et, lvl), want in ELASTICITY_ANCHORS.items():
        r, w = timed(torch, lambda: elasticity.solve(
            ElasticityConfig(etype=ElementType[et], level=lvl), device=device))
        gap = abs(r.energy - want) / want
        check(gap <= 1e-10, f"elasticity {et} L{lvl}: energy {r.energy!r} is {gap:.3e} from "
              f"{want!r}")
        el[(et, lvl)] = r
        say("elasticity", f"dense {et} L{lvl}: {r.mesh.n_nodes} nodes, energy {r.energy!r} (rel "
            f"{gap:.3e} to {want!r}), wall {w:.3f} s | {card}")
    r, w = timed(torch, lambda: elasticity.solve(ElasticityConfig(etype=ElementType.P2),
                                                 device=device))
    check(bool(np.isfinite(r.u).all()) and r.u.shape == (r.mesh.n_nodes, 2) and np.isfinite(
        r.energy), "elasticity P2 L1: bad result")
    say("elasticity", f"dense P2 L1: {r.mesh.n_nodes} nodes, energy {r.energy!r}, wall {w:.3f} s "
        f"| {card}")
    for et in ("P1", "Q2"):
        r, w = timed(torch, lambda: elasticity.solve(
            ElasticityConfig(etype=ElementType[et], solver="cg"), device=device))
        gap = abs(r.energy - el[(et, 1)].energy) / abs(el[(et, 1)].energy)
        check(gap <= 1e-11, f"elasticity cg {et} L1: {gap:.3e} from dense")
        say("elasticity", f"cg {et} L1: energy {r.energy!r} (rel {gap:.3e} to dense), "
            f"{r.cg_iters} CG iterations, wall {w:.3f} s | {card}")
    r, w = timed(torch, lambda: elasticity.solve(ElasticityConfig(level=5, solver="cg"),
                                                 device=device))
    want = float(np.load(FIXTURES / "elasticity_cg.npz")["energy_l5"])
    gap = abs(r.energy - want) / want
    check(gap <= 1e-9, f"elasticity cg L5: energy {r.energy!r} is {gap:.3e} from JAX's {want!r}")
    check(not spmv.LAUNCHES, f"elasticity: launches {dict(spmv.LAUNCHES)}")
    say("elasticity", f"cg P1 L5: {r.mesh.n_nodes} nodes, {2 * r.mesh.n_nodes} DOFs, energy "
        f"{r.energy!r} (rel {gap:.3e} to the JAX package's {want!r}), {r.cg_iters} CG "
        f"iterations, wall {w:.3f} s | {card}")

    # phase 23: the footing's tangent-multigrid preset at levels 2 and 3,
    # three load trips, against the JAX package's runs; before each run
    # the path's kernels at its shapes (once a level)
    shear, bulk = lame_moduli(1e7, 0.48)
    fs_launches, fs_walls = {}, {}
    csr_shapes, csr_err = {}, 0.0
    for level, fixture, kw in ((2, "footing_scale_l2_t3", {}),
                               (2, "footing_scale_l2_damped_t3", dict(newton_damping=3)),
                               (3, "footing_scale_l3_t3", {})):
        tag = f"footing scale L{level}" + (" damped" if kw else "")
        fcfg = FootingConfig.fast_scale(level, max_trips=3, **kw)
        ex_f = {}
        t0 = time.perf_counter()
        run_f, mesh_f = footing.build_df32(fcfg, device=device, extras=ex_f)
        torch.cuda.synchronize()
        setup_f = time.perf_counter() - t0
        if not kw:
            c_f, c_err, k3_f, k4_f, k4_f_err = footing_scale_phase(
                torch, spmv, mg, ex_f, level, shear, bulk, device, card)
            csr_shapes.update(c_f)
            k3_shapes.update(k3_f)
            k4_shapes.update(k4_f)
            csr_err, k4_err = max(csr_err, c_err), max(k4_err, k4_f_err)
        del ex_f
        spmv.LAUNCHES.clear()
        fa, fa_wall = timed(torch, run_f)
        launch_f = dict(spmv.LAUNCHES)
        fb, fb_wall = timed(torch, run_f)
        gaps = check_footing_scale(tag, fa, fcfg, fixture)
        check(footing_counts(fa) == footing_counts(fb) and np.array_equal(fa.u, fb.u),
              f"{tag}: two runs differ")
        check_footing_scale_launches(tag, launch_f, level, fa.n_newton_total, fa.n_cg_total)
        fs_launches[tag.replace(" ", "_")] = launch_f
        say(tag, f"setup {setup_f:.2f} s; {mesh_f.n_nodes} nodes; steps / Newton by trip / CG "
            f"{fa.n_steps} / {fa.newton_trips} / {fa.n_cg_total} (JAX package's {gaps['jax']}), "
            f"load factors {gaps['zeta_gap']:.3e} and pressures {gaps['pressure_gap']:.3e} from "
            f"JAX's, launches {launch_f}, repeat bit-identical, wall first {fa_wall:.3f} s warm "
            f"{fb_wall:.3f} s | {card}")
        del run_f

    # phase 24: the path's kernels at level 4's shapes
    cfg4f = FootingConfig.fast_scale(4, max_trips=3)
    ex4f = {}
    t0 = time.perf_counter()
    run4f, mesh4f = footing.build_df32(cfg4f, device=device, extras=ex4f)
    torch.cuda.synchronize()
    setup4f = time.perf_counter() - t0
    say("footing scale L4", f"setup {setup4f:.2f} s (host: hierarchy, Galerkin maps, G/S); "
        f"{mesh4f.n_nodes} nodes, {int(mesh4f.free.sum())} unknowns, hierarchy rows "
        f"{[lev.free.shape[0] for lev in ex4f['hierarchy'].levels]}, Galerkin map entries "
        f"{[int(M.values.numel()) for M in ex4f['tangent'].mhat]} | {card}")
    c_f, c_err, k3_f, k4_f, k4_f_err = footing_scale_phase(
        torch, spmv, mg, ex4f, 4, shear, bulk, device, card)
    csr_shapes.update(c_f)
    k3_shapes.update(k3_f)
    k4_shapes.update(k4_f)
    csr_err, k4_err = max(csr_err, c_err), max(k4_err, k4_f_err)
    del ex4f

    # phase 25: fast_scale(4), three load trips, twice
    spmv.LAUNCHES.clear()
    f4a, f4_first = timed(torch, run4f)
    fs_launches["footing_scale_L4"] = dict(spmv.LAUNCHES)
    f4b, f4_warm = timed(torch, run4f)
    check(f4a.u.shape == (mesh4f.n_nodes, 2) and bool(np.isfinite(f4a.u).all()
                                                      and np.isfinite(f4a.ep).all()),
          "footing scale L4: bad field")
    check(f4a.n_steps >= 1, f"footing scale L4: {f4a.n_steps} steps in three trips")
    check(footing_counts(f4a) == footing_counts(f4b) and np.array_equal(f4a.u, f4b.u),
          "footing scale L4: two runs differ")
    check_footing_scale_launches("footing scale L4", fs_launches["footing_scale_L4"], 4,
                                 f4a.n_newton_total, f4a.n_cg_total)
    say("footing scale L4", f"steps / Newton by trip / CG / plastic {f4a.n_steps} / "
        f"{f4a.newton_trips} / {f4a.n_cg_total} / {f4a.n_plastic}, zeta {f4a.zeta_trips}, last "
        f"pressure {float(f4a.pressure_hist[f4a.n_steps])!r}, u sha256 {u_digest(f4a.u)}, "
        f"launches {fs_launches['footing_scale_L4']}, repeat bit-identical, wall first "
        f"{f4_first:.3f} s warm {f4_warm:.3f} s, {1e3 * f4_warm / f4a.n_cg_total:.4f} ms a CG "
        f"iteration (warm wall over CG iterations) | {card}")
    del run4f

    # phase 26: level 5, one load trip resumed from the banked checkpoint
    # (damped Newton, deflation ring)
    cfg5f = FootingConfig.fast_scale(5, max_trips=1)
    ex5f = {}
    t0 = time.perf_counter()
    run5f, mesh5f = footing.build_df32(cfg5f, device=device, extras=ex5f)
    torch.cuda.synchronize()
    setup5f = time.perf_counter() - t0
    th5f = ex5f["tangent"]
    carry5 = load_checkpoint(ROOT / "checkpoints" / "footing_l5_k16.npz", device=device)
    check(carry5["u"].shape == (2 * mesh5f.n_nodes,) and carry5["ep"].shape[1] == mesh5f.n_elems
          and carry5["defl_w"].shape == (2 * mesh5f.n_nodes, 16),
          f"footing scale L5: the checkpoint's shapes do not fit the mesh")
    say("footing scale L5", f"setup {setup5f:.2f} s (host: hierarchy, Galerkin maps, G/S); "
        f"{mesh5f.n_nodes} nodes, {int(mesh5f.free.sum())} unknowns, hierarchy rows "
        f"{[lev.free.shape[0] for lev in ex5f['hierarchy'].levels]}, Galerkin map entries "
        f"{[int(M.values.numel()) for M in th5f.mhat]}; checkpoint at step "
        f"{carry5['step']}, zeta {carry5['zeta_old']!r}, d_zeta {carry5['d_zeta']!r} | {card}")
    c_f, c_err, k3_f, k4_f, k4_f_err = footing_scale_phase(
        torch, spmv, mg, ex5f, 5, shear, bulk, device, card)
    csr_shapes.update(c_f)
    k3_shapes.update(k3_f)
    k4_shapes.update(k4_f)
    csr_err, k4_err = max(csr_err, c_err), max(k4_err, k4_f_err)
    del th5f, ex5f
    spmv.LAUNCHES.clear()
    torch.cuda.reset_peak_memory_stats()
    g5a, g5_first = timed(torch, lambda: run5f(resume=carry5))
    fs_launches["footing_scale_L5"] = dict(spmv.LAUNCHES)
    n_newton5 = g5a.n_newton_total - carry5["nits_total"]
    n_cg5 = g5a.n_cg_total - carry5["ncg_total"]
    check(g5a.u.shape == (mesh5f.n_nodes, 2) and bool(np.isfinite(g5a.u).all()
                                                      and np.isfinite(g5a.ep).all()),
          "footing scale L5: bad field")
    check_footing_scale_launches("footing scale L5", fs_launches["footing_scale_L5"], 5,
                                 n_newton5, n_cg5)
    accepted5 = g5a.n_steps + 1 > carry5["step"]
    p5 = float(g5a.pressure_hist[g5a.n_steps]) if accepted5 else None
    if g5_first <= L5_REPEAT_LIMIT_S:
        g5b, g5_warm = timed(torch, lambda: run5f(resume=carry5))
        check(footing_counts(g5a) == footing_counts(g5b) and np.array_equal(g5a.u, g5b.u),
              "footing scale L5: two runs differ")
        repeat5 = f"repeat bit-identical, wall first {g5_first:.3f} s warm {g5_warm:.3f} s"
    else:
        repeat5 = (f"wall {g5_first:.3f} s, over {L5_REPEAT_LIMIT_S:.0f} s: run once, "
                   f"bit-identity held at level 4")
    say("footing scale L5", f"one trip from the checkpoint: {n_newton5} Newton iterations, "
        f"{n_cg5} CG iterations, CG solves {g5a.cg_trips[0]}, "
        f"{'accepted' if accepted5 else 'rejected'}, zeta {g5a.zeta_trips[0]!r}, "
        f"d_zeta {g5a.carry['d_zeta']!r}, pressure {p5!r}, last criterion "
        f"{g5a.crit_trips[0]:.3e}, u sha256 {u_digest(g5a.u)}, launches "
        f"{fs_launches['footing_scale_L5']}, {repeat5}, peak device memory "
        f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB | {card}")
    del run5f, carry5

    # phase 27: the P4 production route, the reference's own
    # configuration (p-multigrid, the tangent on the f32 heads of G and S),
    # full schedule, twice
    from fem_elastoplasticity_tpu_torch.ops import assembly_df as adf

    t_phase = time.perf_counter()
    hi_launches = {}
    cfg_p4 = TsxTunnelConfig.fast(etype=ElementType.P4, solver="ell")
    check(cfg_p4.gs_tangent_on, "tsx P4: gs_tangent auto is off")
    p4, p4_res, p4_setup, p4_first, p4_warm, l_p4, ex_p4, run_p4, _ = df32_twice(
        torch, spmv, tsx, cfg_p4, device)
    hi_launches["tsx_P4_pmg"] = l_p4
    p4_busy, p4_idle, p4_kernels = idle_share(run_p4)
    check(p4.u.shape == (7226, 2) and bool(np.isfinite(p4.u).all() and np.isfinite(p4.ep).all()),
          f"tsx P4: bad field {p4.u.shape}")
    p4_counts = (p4.n_steps, p4.n_newton_total, p4.n_plastic)
    if p4_counts != JAX_COUNTS_P4:
        say("tsx P4", f"parts from the f64 anchor's {JAX_COUNTS_P4}: Newton by trip "
            f"{p4_res.newton_trips}, last criterion by trip {p4_res.crit_trips}, zeta "
            f"{p4_res.zeta_trips} | {card}")
    check(p4_counts == JAX_COUNTS_P4, f"tsx P4: steps / Newton / plastic {p4_counts}, the f64 "
          f"anchor's {JAX_COUNTS_P4}")
    p4_u40 = float(p4.u[40, 0])
    p4_rel = abs(p4_u40 - ANCHOR_U40_P4) / abs(ANCHOR_U40_P4)
    check(p4_rel <= 1e-6, f"tsx P4: u40 {p4_u40!r} is {p4_rel:.3e} from the anchor")
    check_pmg_launches("tsx P4", l_p4, p4.n_cg_total, True)
    say("tsx P4", f"fast(etype=P4, solver='ell'), gs_tangent auto (on): setup {p4_setup:.3f} s; "
        f"steps / Newton / CG / plastic {(p4.n_steps, p4.n_newton_total, p4.n_cg_total, p4.n_plastic)} "
        f"(the f64 anchor's steps / Newton / plastic {JAX_COUNTS_P4}), Newton by trip "
        f"{p4_res.newton_trips}, u40 {p4_u40:.12e} (rel {p4_rel:.3e} to {ANCHOR_U40_P4}), u sha256 "
        f"{u_digest(p4.u)}, launches {l_p4}, repeat bit-identical, wall first {p4_first:.3f} s "
        f"warm {p4_warm:.3f} s, {1e3 * p4_warm / p4.n_cg_total:.4f} ms a CG iteration; profiled "
        f"run: {busy_line(p4_busy, p4_idle, p4_kernels)}"
        f"{'' if p4_kernels is None else f' ({p4_kernels / p4.n_cg_total:.1f} a CG iteration)'}"
        f" | {card}")
    say("phase time", f"tsx P4 full schedule {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 28: the P2 and P4 routes cut at the JAX fixtures, twice each
    t_phase = time.perf_counter()
    hi_launches.update(high_order_route_phase(torch, spmv, tsx, TsxTunnelConfig, ElementType,
                                              device, card))
    say("phase time", f"high-order routes {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 29: the high-order routes past the first plastic step, once each
    t_phase = time.perf_counter()
    hi_launches.update(high_order_plastic_phase(torch, spmv, tsx, TsxTunnelConfig, ElementType,
                                                device, card))
    say("phase time", f"high-order plastic routes {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 30: the 228,112-DOF high-order meshes, P4 refine 2 and P2
    # refine 3 (the P1 refine-4 lattice), full schedule, twice each
    t_phase = time.perf_counter()
    big = {}
    for et, refine in (("P4", 2), ("P2", 3)):
        tag = f"tsx {et} refine {refine}"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        held = torch.cuda.memory_allocated()
        cfg_big = TsxTunnelConfig.fast(etype=ElementType[et], solver="ell", refine_levels=refine)
        rb, rb_res, rb_setup, rb_first, rb_warm, l_big, ex_big, run_big, _ = df32_twice(
            torch, spmv, tsx, cfg_big, device)
        peak = (torch.cuda.max_memory_allocated() - held) / 2**30
        hi_launches[f"tsx_{et}_refine{refine}_pmg"] = l_big
        check(rb.u.shape == (114056, 2) and bool(np.isfinite(rb.u).all()
                                                 and np.isfinite(rb.ep).all()),
              f"{tag}: bad field {rb.u.shape}")
        check(rb.n_steps == 17, f"{tag}: {rb.n_steps} steps")
        # no JAX run at this size: a plausibility check, not parity
        big_rel = abs(float(rb.u[40, 0]) - p4_u40) / abs(p4_u40)
        check(big_rel <= 1e-2, f"{tag}: u40 {float(rb.u[40, 0])!r} is {big_rel:.3e} from P4's")
        check_pmg_launches(tag, l_big, rb.n_cg_total, True)
        say(tag, f"{2 * rb.u.shape[0]} DOFs, {int(ex_big['reference_mesh'].free.sum())} unknowns, "
            f"hierarchy rows {[lev.free.shape[0] for lev in ex_big['hierarchy'].levels]}: setup "
            f"{rb_setup:.2f} s; steps / Newton / CG / plastic "
            f"{(rb.n_steps, rb.n_newton_total, rb.n_cg_total, rb.n_plastic)}, u40 "
            f"{float(rb.u[40, 0]):.9e} (rel {big_rel:.3e} to P4 L0's), u sha256 "
            f"{u_digest(rb.u)}, launches {l_big}, repeat bit-identical, wall first "
            f"{rb_first:.3f} s warm {rb_warm:.3f} s ({1e3 * rb_warm / rb.n_cg_total:.4f} ms a CG "
            f"iteration), peak device memory of setup and runs {peak:.3f} GiB | {card}")
        big[et] = ex_big
        del run_big
    say("phase time", f"228,112-DOF runs {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 31: the path's kernels at the high-order shapes, each against its
    # plain version: K1 on G and S and K3's CSR kernel on their f32 heads
    # (P2 and P4 on the tsx mesh, P4 refine 2), K3's product on the assembled
    # P2 / P4 elastic K, K3's transfers and K4 on the p-multigrid levels
    t_phase = time.perf_counter()
    ex_p2 = {}
    tsx.build_df32(TsxTunnelConfig.fast(etype=ElementType.P2, solver="ell"), device=device,
                   extras=ex_p2)
    ho_cases = {}
    for tag, ex in (("P2_L0", ex_p2), ("P4_L0", ex_p4), ("P4_R2", big["P4"])):
        G, S = ex["residual_op"]
        G32, S32 = adf.f32_heads(G, S)
        ho_cases.update({f"G_{tag}": G, f"S_{tag}": S, f"G32_{tag}": G32, f"S32_{tag}": S32})
    ho_csr, ho_csr_err = csr_phase(torch, spmv, ho_cases, device, card)
    shear_t, bulk_t = lame_moduli(TsxTunnelConfig().young, TsxTunnelConfig().poisson)
    k3_ho_cases = {}
    for et in ("P2", "P4"):
        ex_a = {}
        _, mesh_a = tsx.build_df32(TsxTunnelConfig.fast(
            etype=ElementType[et], solver="cg", assembled_cg=True), device=device, extras=ex_a)
        K_a = spmv.build_elastic_csr(mesh_a.coords, mesh_a.elems, volume_element(ElementType[et]),
                                     shear_t, bulk_t, free=mesh_a.free)
        B_a = ex_a["elastic_op"]
        say("K3", f"{et} assembled elastic K: {B_a.n_nodes} nodes, {B_a.block_cols.numel()} "
            f"blocks, width {B_a.width}, blocks a node {blocks_histogram(torch, B_a)} | {card}")
        k3_ho_cases[f"K_{et}_assembled"] = (B_a, spmv.csr_to_device(K_a, device, np.float32),
                                            None, False)
    for tag, ex in (("P4pmg", ex_p4), ("P4R2pmg", big["P4"])):
        k3_ho_cases.update({k: v for k, v in k3_cases(
            spmv, ex["hierarchy"], ex["host_levels"], device, tag).items()
            if not k.startswith("K_")})
    k3_ho = k3_phase(torch, spmv, k3_ho_cases, device, card)
    k3_shapes.update(k3_ho)
    lv_p4, lv_r2 = ex_p4["hierarchy"].levels, big["P4"]["hierarchy"].levels
    k4_ho, k4_ho_err = k4_phase(torch, spmv, {
        **{f"P4pmg_level{i}": (spmv.csr_to_device(ex_p4["host_levels"][i]["K"], device,
                                                  np.float32), lv_p4[i])
           for i in range(1, len(lv_p4))},
        f"P4R2pmg_level{len(lv_r2) - 1}": (spmv.csr_to_device(
            big["P4"]["host_levels"][-1]["K"], device, np.float32), lv_r2[-1])}, device, card)
    k4_shapes.update(k4_ho)
    k4_err = max(k4_err, k4_ho_err)
    del ex_p2, ex_p4, big, run_p4
    say("phase time", f"high-order kernels {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 32: K2's member-batched instance against its plain version and
    # against 64 single launches
    t_phase = time.perf_counter()
    k2b_shapes, k2b_err = k2_batched_phase(torch, rm, device, card)
    say("phase time", f"K2 batched {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 33: the four 64-member ensembles, each against its members'
    # single solves
    t_phase = time.perf_counter()
    ens_runs, k2_ens, ens_results = ensemble_phase(torch, tsx, TsxTunnelConfig, device, card)
    say("phase time", f"ensembles {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 34: the footing's Q1, P2 and Q2 elements
    t_phase = time.perf_counter()
    et_launches, et_extras = footing_etypes_phase(torch, spmv, footing, FootingConfig,
                                                  ElementType, device, card)
    say("phase time", f"footing element types {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 35: the tsx's last single-card options
    t_phase = time.perf_counter()
    opt_launches, opt_builds = tsx_options_phase(
        torch, spmv, tsx, TsxTunnelConfig, ElementType, device, card,
        {1: (s1.n_steps, s1.n_newton_total, s1.n_cg_total, s1.n_plastic), 4: counts4(a1)})
    say("phase time", f"tsx options {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 36: the kernels at the shapes of phases 34-35
    t_phase = time.perf_counter()
    (csr_o, csr_o_err, k3_o, k4_o, k4_o_err, k6_o, k6_o_err) = option_kernels_phase(
        torch, spmv, adf, footing, FootingConfig, et_extras, opt_builds, device, card,
        ElementType, volume_element)
    k3_shapes.update(k3_o)
    k4_shapes.update(k4_o)
    k4_err = max(k4_err, k4_o_err)
    k6_shapes.update(k6_o)
    k6_err = {k: max(v, k6_o_err[k]) for k, v in k6_err.items()}
    del et_extras, opt_builds
    say("phase time", f"option kernels {time.perf_counter() - t_phase:.1f} s | {card}")
    new_launches = {**et_launches, **opt_launches}

    # phase 37: multi-device runs, N ranks on the card; then K4's split-z
    # instance on L4's levels cut into 4 row slices
    t_phase = time.perf_counter()
    from fem_elastoplasticity_tpu_torch.parallel import sharding

    shard_rec, shard_launches = sharded_phase(
        torch, spmv, tsx, footing, TsxTunnelConfig, FootingConfig,
        {"scale1": s1, "scale4": a1, "ensemble_df32": ens_results["df32"]}, device, card)
    k4_split = split_z_phase(torch, spmv, sharding, ex4["hierarchy"], ex4["host_levels"], 4,
                             device, card)
    ens_ref = {k: ens_results[k] for k in ("f32", "df32")}  # phase 39's
    del ens_results
    say("phase time", f"sharded runs {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 38: the side layers (the example scripts, checkpoint, timing,
    # metrics)
    t_phase = time.perf_counter()
    side_launches = side_layers_phase(torch, spmv, tsx, TsxTunnelConfig, bench_digest,
                                      device, card)
    say("phase time", f"side layers {time.perf_counter() - t_phase:.1f} s | {card}")

    # phase 39: the sweeps of benchmarks/, in-process
    t_phase = time.perf_counter()
    sweep_paths = {f"sweeps_{k}": v for k, v in sweeps_phase(
        torch, spmv, rm, tsx, footing, TsxTunnelConfig, FootingConfig, {
            "scale1": (s1.n_steps, s1.n_newton_total, s1.n_cg_total, s1.n_plastic),
            "p4": (p4.n_steps, p4.n_newton_total, p4.n_cg_total, p4.n_plastic),
            "ensembles": ens_ref}, device, card).items()}
    del ens_ref
    say("phase time", f"sweeps {time.perf_counter() - t_phase:.1f} s | {card}")

    say("total", f"{time.perf_counter() - t_start:.1f} s from start to here, builds included "
        f"| {card}")

    l0 = ("G_L0", "S_L0")
    mhat_top5 = max((k for k in csr_shapes if k.startswith("Mhat_L5")), key=lambda k: csr_shapes[k]["nnz"])
    by_path = lambda name, **paths: {k: v.get(name, 0) for k, v in paths.items()}  # noqa: E731
    main_k2 = k2_shapes["n896_float32_noep"]  # one Newton-iteration call of the f32 paths
    kernels = [{
        "name": "csr_spmv_f64",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/csr_spmv.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1370",
        "launches_by_path": by_path("csr_spmv_f64", bench=launches,
                                    bench_checkpoint_resumed=side_launches, scale_L1=l1_launches,
                                    scale_L4=l4_launches, scale_ELL_L1=e1_launches,
                                    scale_ELL_L4=e4_launches, scale_L5=l5_launches,
                                    footing_acg_z002=foot_launches["df32_acg_z002"],
                                    footing_acg_L3=foot_launches["df32_acg_L3"], **fs_launches,
                                    **hi_launches, **new_launches, **shard_launches,
                                    **sweep_paths),
        "max_abs_err": max(k1_err, csr_o_err,
                           max(v["max_abs_err"] for k, v in csr_shapes.items()
                               if k.startswith("footing_")),
                           max(v["max_abs_err"] for k, v in ho_csr.items()
                               if not k[1:].startswith("32"))),
        # one residual evaluation of the main path: G u then S s, level 0
        "ms": sum(k1_shapes[k]["ms"] for k in l0),
        "plain_ms": sum(k1_shapes[k]["plain_ms"] for k in l0),
        "bound_ms": sum(k1_shapes[k]["bound_ms"] for k in l0),
        "bound_by": "bytes",
        "library_ms": sum(k1_shapes[k]["library_ms"] for k in l0),
        "shapes": {**k1_shapes, **{k: v for k, v in csr_shapes.items()
                                   if k.startswith("footing_")},
                   **{k: v for k, v in ho_csr.items() if not k[1:].startswith("32")}, **csr_o},
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
        "launch_floor_ms": main_k2["launch_floor_ms"],
        "bitwise_equal_to_plain": k2_bitwise,
        "shapes": k2_shapes,
    }, {
        "name": "dp_return_map_batched",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/dp_return_map.cu",
        # K2's member-batched instance: the Pallas kernel under the JAX
        # ensemble's vmap
        "replaces": "fem_elastoplasticity_tpu/ops/return_map_pallas.py:160",
        "launches_by_path": by_path("dp_return_map_batched", ensemble_f32=k2_ens,
                                    **sweep_paths),
        "max_abs_err": k2b_err,
        # one Newton sweep of the 64-member f32 ensemble: 64 x 896 points
        **{key: k2b_shapes["B64_n896_float32_noep"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "singles_ms",
                       "launch_floor_ms")},
        # no single PyTorch call computes the return map
        "library_ms": None,
        "bitwise_equal_to_plain": True,
        "bitwise_equal_to_single_launches": True,
        "shapes": k2b_shapes,
        "ensembles": ens_runs,
    }, {
        "name": "node_block_spmv",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/block_jacobi_sweep.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1431",
        "launches_by_path": by_path("node_block_spmv", scale_L1=l1_launches,
                                    scale_L4=l4_launches, scale_L5=l5_launches,
                                    footing_acg_z002=foot_launches["df32_acg_z002"],
                                    footing_acg_L3=foot_launches["df32_acg_L3"], **fs_launches,
                                    **hi_launches, **new_launches, **shard_launches,
                                    **sweep_paths),
        # bitwise equal to its plain version (and to the earlier design)
        "max_abs_err": max(v["max_abs_err"] for k, v in k3_shapes.items() if k.startswith("K_")),
        # the CG operator of the level-5 solve; the bound is the node-block
        # layout's bytes, the CSR entries' beside it
        "ms": k3_shapes["K_L5"]["ms"],
        "plain_ms": k3_shapes["K_L5"]["plain_ms"],
        "bound_ms": k3_shapes["K_L5"]["bound_ms"],
        "bound_by": k3_shapes["K_L5"]["bound_by"],
        "csr_bound_ms": k3_shapes["K_L5"]["csr_bound_ms"],
        "library_ms": k3_shapes["K_L5"]["library_ms"],
        "csr_kernel_ms_same_operator": k3_shapes["K_L5"]["csr_kernel_ms"],
        "bitwise_equal_to_plain": True,
        "shapes": {k: v for k, v in k3_shapes.items() if k.startswith("K_")},
    }, {
        "name": "node_transfer",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/node_transfer.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1455",
        "launches_by_path": by_path("node_transfer", scale_L1=l1_launches,
                                    scale_L4=l4_launches, scale_L5=l5_launches, **fs_launches,
                                    **hi_launches, **new_launches, **shard_launches,
                                    **sweep_paths),
        "max_abs_err": max(v["max_abs_err"] for k, v in k3_shapes.items()
                           if not k.startswith("K_")),
        # one V-cycle's transfers of the level-5 solve: R and P of levels 1-5
        **{key: sum(v[key] for k, v in k3_shapes.items() if k[1:].startswith("_L5_level"))
           for key in ("ms", "plain_ms", "bound_ms", "csr_bound_ms", "library_ms",
                       "csr_kernel_ms")},
        "bound_by": "bytes",
        "bitwise_equal_to_plain": True,
        "shapes": {k: v for k, v in k3_shapes.items() if not k.startswith("K_")},
    }, {
        "name": "block_jacobi_sweep",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/block_jacobi_sweep.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1610",
        "launches_by_path": by_path("block_jacobi_sweep", scale_L1=l1_launches,
                                    scale_L4=l4_launches, scale_L5=l5_launches, **fs_launches,
                                    **hi_launches, **new_launches, **sweep_paths),
        "max_abs_err": k4_err,
        # one smoother sweep on the fine level of the level-4 solve; the
        # bound is the node-block layout's bytes, the CSR entries' beside it
        "ms": k4_shapes["L4_update"]["ms"],
        "plain_ms": k4_shapes["L4_update"]["plain_ms"],
        "bound_ms": k4_shapes["L4_update"]["bound_ms"],
        "bound_by": k4_shapes["L4_update"]["bound_by"],
        "csr_bound_ms": k4_shapes["L4_update"]["csr_bound_ms"],
        "bitwise_equal_to_plain": all(v["bitwise_equal_to_plain"] for v in k4_shapes.values()),
        # no single PyTorch call computes the sweep: a sparse product plus
        # the masked 2x2 block update
        "library_ms": None,
        "shapes": k4_shapes,
    }, {
        # K4's split-z instance: the sweep on one rank's row slice of a
        # row-sharded level (the JAX package's ShardedMeta branch of
        # slot_sweep); the same source and entry, with a node offset
        "name": "block_jacobi_sweep_split",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/block_jacobi_sweep.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1675",
        "launches_by_path": by_path("block_jacobi_sweep_split", **shard_launches),
        "max_abs_err": 0.0,
        # one sweep of L4's fine level as four row slices (four launches)
        **{key: k4_split["L4_level4_x4_update"][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "unsharded_ms")},
        "bitwise_equal_to_plain": True,
        "bitwise_equal_to_unsharded_rows": True,
        # no single PyTorch call computes the sweep
        "library_ms": None,
        "shapes": k4_split,
        "sharded_runs": shard_rec,
    }, {
        "name": "csr_spmv_f32",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/csr_spmv.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1431",
        # the Galerkin value maps of the footing's tangent multigrid; the
        # f32 heads of G and S on the tsx's p-multigrid route
        "launches_by_path": by_path("csr_spmv_f32", **fs_launches, **hi_launches,
                                    **shard_launches, **sweep_paths),
        "max_abs_err": max(max(v["max_abs_err"] for k, v in csr_shapes.items()
                               if k.startswith("Mhat_")),
                           max(v["max_abs_err"] for k, v in ho_csr.items()
                               if k[1:].startswith("32"))),
        # the level-5 solve's map of its fine values onto level 4's (the
        # largest; one launch a Newton iteration)
        **{key: csr_shapes[mhat_top5][key]
           for key in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
        "shapes": {**{k: v for k, v in csr_shapes.items() if k.startswith("Mhat_")},
                   **{k: v for k, v in ho_csr.items() if k[1:].startswith("32")}},
    }, {
        "name": "block_jacobi_sweep_bf16",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/block_jacobi_sweep.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:1936",
        "launches_by_path": by_path("block_jacobi_sweep_bf16", scale_L5=l5_launches,
                                    **sweep_paths),
        "max_abs_err": k5_err,
        # one smoother sweep on the fine level of the level-5 solve
        "ms": k5_shapes["L5_update"]["ms"],
        "plain_ms": k5_shapes["L5_update"]["plain_ms"],
        "bound_ms": k5_shapes["L5_update"]["bound_ms"],
        "bound_by": k5_shapes["L5_update"]["bound_by"],
        "csr_bound_ms": k5_shapes["L5_update"]["csr_bound_ms"],
        "bitwise_equal_to_plain": all(v["bitwise_equal_to_plain"] for v in k5_shapes.values()),
        # no single PyTorch call computes the sweep
        "library_ms": None,
        "k4_f32_ms_same_operator": k5_shapes["L5_update"]["k4_f32_ms"],
        "bitwise_equal_to_k4_on_widened_values": k5_bitwise,
        "shapes": k5_shapes,
    }, {
        "name": "ell_spmv_f32",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/ell_spmv.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:417",
        "launches_by_path": by_path("ell_spmv_f32", scale_ELL_L1=e1_launches,
                                    scale_ELL_L4=e4_launches, **new_launches, **sweep_paths),
        "max_abs_err": k6_err["float32"],
        # the CG operator of the level-4 ELL solve
        "ms": k6_shapes["K_L4"]["ms"],
        "plain_ms": k6_shapes["K_L4"]["plain_ms"],
        "bound_ms": k6_shapes["K_L4"]["bound_ms"],
        "bound_by": k6_shapes["K_L4"]["bound_by"],
        "library_ms": k6_shapes["K_L4"]["library_ms"],
        "csr_kernel_ms_same_operator": k6_shapes["K_L4"]["csr_kernel_ms"],
        "shapes": {k: v for k, v in k6_shapes.items() if v["dtype"] == "float32"},
    }, {
        "name": "ell_spmv_f64",
        "route": "cuda",
        "source": "fem_elastoplasticity_tpu_torch/ops/csrc/ell_spmv.cu",
        "replaces": "fem_elastoplasticity_tpu/ops/spmv.py:902",
        "launches_by_path": by_path("ell_spmv_f64", scale_ELL_L1=e1_launches,
                                    scale_ELL_L4=e4_launches, **new_launches, **sweep_paths),
        "max_abs_err": k6_err["float64"],
        # one residual evaluation of the level-4 ELL solve: G u, then S s
        "ms": k6_shapes["G_L4"]["ms"] + k6_shapes["S_L4"]["ms"],
        "plain_ms": k6_shapes["G_L4"]["plain_ms"] + k6_shapes["S_L4"]["plain_ms"],
        "bound_ms": k6_shapes["G_L4"]["bound_ms"] + k6_shapes["S_L4"]["bound_ms"],
        "bound_by": ("bytes" if {k6_shapes["G_L4"]["bound_by"], k6_shapes["S_L4"]["bound_by"]}
                     == {"bytes"} else "operations"),
        "library_ms": k6_shapes["G_L4"]["library_ms"] + k6_shapes["S_L4"]["library_ms"],
        "csr_kernel_ms_same_operator": (k6_shapes["G_L4"]["csr_kernel_ms"]
                                        + k6_shapes["S_L4"]["csr_kernel_ms"]),
        "shapes": {k: v for k, v in k6_shapes.items() if v["dtype"] == "float64"},
    }]
    # K7: its own entry points; the main case is n = 908, the size of the
    # tsx dense paths' factor
    main_k7 = k7_shapes["tsx_scaled_908"]
    for part, replaces in (("factor", "fem_elastoplasticity_tpu/ops/cholesky_pallas.py:140"),
                           ("solve", "fem_elastoplasticity_tpu/ops/cholesky_pallas.py:179")):
        kernels.append({
            "name": f"cholesky_{part}",
            "route": "cuda",
            "source": "fem_elastoplasticity_tpu_torch/ops/csrc/cholesky_blocked.cu",
            "replaces": replaces,
            # kernels launched: one a factorization, one a solve
            "launches": k7_launches[f"cholesky_{part}"],
            "launches_by_path": {"cholesky_entry_points": k7_launches[f"cholesky_{part}"]},
            **({"factorizations": k7_launches["cholesky_factorizations"]}
               if part == "factor" else {}),
            "max_abs_err": max(v[f"{part}_max_abs_err"] for v in k7_shapes.values()),
            "ms": main_k7[f"{part}_ms"],
            "plain_ms": main_k7[f"{part}_plain_ms"],
            "bound_ms": main_k7[f"{part}_bound_ms"],
            "bound_by": main_k7[f"{part}_bound_by"],
            # cuSOLVER: torch.linalg.cholesky_ex / torch.cholesky_solve
            "library_ms": main_k7[f"{part}_library_ms"],
            "shapes": {k: {kk: vv for kk, vv in v.items()
                           if kk.startswith(part) or not kk.startswith(("factor", "solve"))}
                       for k, v in k7_shapes.items()},
        })
    for k in kernels:  # launches on the main paths, all paths together
        k.setdefault("launches", sum(k["launches_by_path"].values()))
    print(json.dumps({"card": card, "kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
