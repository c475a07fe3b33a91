"""Elasticity, TSX tunnel and strip-footing configurations.

Port of `fem_elastoplasticity_tpu/models/config.py` (`ElasticityConfig` at
:16, `FootingConfig` at :39, `TsxTunnelConfig` at :188) with the same field
names and defaults, so a configuration reads the same in both packages.
The elasticity problem runs P1, P2, Q1 and Q2 elements, dense or by
matrix-free CG.  The footing runs P1, P2, Q1 and Q2 elements: dense in
native f64 and f32 and in "df32", and with block-Jacobi CG tangent solves
(matrix-free or, in df32, `assembled_cg`), and at P1 with the
tangent-multigrid CG of `FootingConfig.fast_scale`.  The tsx runs P1, P2
and P4 triangles: dense in native f64 and f32 and in df32; with
`solver="cg"` (block-Jacobi PCG tangent solves) in native precision and in
df32, matrix-free or, with `assembled_cg`, on the assembled elastic
operator plus the gathered plastic correction; with `solver="mg"` at P1
(CG preconditioned by the matrix-free geometric multigrid V-cycle of the
refinement hierarchy) in native precision and in df32; and with
`solver="ell"` (multigrid-preconditioned CG, `TsxTunnelConfig.fast_scale`)
in df32, at P1 on refined meshes with the hierarchy in CSR
(`spmv_fmt="slot"`) or ELL (`"ell"`), V- or W-cycles (`mg_cycle`), and the
plastic tangent correction scattered into the operator's values once a
Newton iteration (`corr_mode="scatter"`) or gathered in every CG product
(`"gather"`), and at P2/P4 as p-multigrid: the P1 hierarchy of the same
node lattice preconditions the high-order tangent, which is applied on the
f32 heads of the residual operators (`gs_tangent`) or matrix-free.  The
residual operators are CSR (`residual_fmt` None, "slot" or "rslot": the
JAX package's slot layouts are TPU tile geometry, and the card takes the
CSR) or ELL.  Every CG route takes `cg_structure="scan"` (fixed trip
counts) and, in df32, a recycled deflation basis (`cg_deflate`); the tsx
takes a ramped support pressure on the tunnel wall (`support_pressure`).
A field whose value selects something the port does not implement raises
NotImplementedError when the config is built; no field is ignored.  Still
refused: the footing's `tangent_mg` beyond P1, which the JAX package does
not run either (`solve/multigrid.py:493` asserts n_q == 1).  Multi-device
runs are no field here, as in the JAX package: they are entry points
(`tsx_tunnel.solve_sharded`, `solve_sharded_df32`, `solve_sharded_scale`,
`footing.solve_sharded`) and the `shard_devices` argument of the builders
and of the df32 ensemble (`parallel/sharding.py`).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..ops.elements import ElementType
from ..utils.precision import dtype_policy

@dataclass(frozen=True)
class ElasticityConfig:
    """Square-with-hole linear elasticity (`Elasticity2D/pythonFEM.py:1052-1179`)."""

    etype: ElementType = ElementType.P1
    level: int = 1
    young: float = 206900.0
    poisson: float = 0.29
    volume_force: tuple = (0.0, -1.0)
    traction_force: tuple = (0.0, 450.0)
    size_xy: float = 10.0
    size_hole: float = 5.0
    dirichlet_scale: float = 0.5  # ud = 0.5 * dirichlet pattern (E:1141)
    dtype: str = "float64"
    # "dense" (Cholesky of the free-DOF stiffness) | "cg" (matrix-free
    # block-Jacobi PCG)
    solver: str = "dense"
    cg_tol: float = None  # None -> 1e-12 (f64) / 2e-7 (f32)
    cg_maxiter: int = 5000

    def __post_init__(self):
        if self.solver not in ("dense", "cg"):
            raise NotImplementedError(f"ElasticityConfig.solver={self.solver!r}")
        if self.dtype not in ("float64", "float32"):
            raise NotImplementedError(f"ElasticityConfig.dtype={self.dtype!r}")


# the CG loop's forms (`solve.cg.solve_cg` structure)
CG_STRUCTURES = ("while", "scan")
# fields that only the assembled multigrid-CG path (solver="ell") reads;
# solver="mg" reads mg_nu too
_ELL_ONLY = dict(spmv_fmt="slot", corr_mode="gather", mg_cycle="v")
_MG_ONLY = dict(mg_nu=2)
# fields that only the iterative tangent solves (solver "cg", "mg" or
# "ell") read
_ITERATIVE_ONLY = dict(predictor_ir_iters=4, cg_tol=None, cg_maxiter=2000, cg_eta0=None,
                       cg_cap_relax=None, cg_structure="while", cg_deflate=0)
# fields that the native CG path never passes on (JAX `models/tsx_tunnel.py
# solve`): its predictor is one PCG solve, its stepper takes no forcing and
# no deflation basis
_DF32_ONLY = dict(predictor_ir_iters=4, cg_eta0=None, cg_cap_relax=None, cg_deflate=0)
# the P1 hierarchy levels that a high-order element's node lattice adds:
# the P2 / P4 lattice of a mesh is its P1 lattice refined once / twice
P_EXTRA = {ElementType.P1: 0, ElementType.P2: 1, ElementType.P4: 2}
RESIDUAL_FMTS = (None, "slot", "rslot", "ell")


@dataclass(frozen=True)
class TsxTunnelConfig:
    """TSX tunnel excavation (`tsx-tunnel/pythonFEM.py:1637-1851`)."""

    etype: ElementType = ElementType.P1
    young: float = 60000.0
    poisson: float = 0.2
    cohesion: float = 18.7
    friction_angle: float = float(49.0 * np.pi / 180.0)
    init_stress: tuple = (-45.0, -11.0, 0.0, -60.0)
    d_zeta: float = 1.0 / 17.0
    d_zeta_min_ratio: float = 1.0 / 10.0
    zeta_max: float = 1.0
    newton_maxit: int = 25
    newton_tol: float = 1e-12
    accept_tol: float = 1e-10
    max_steps: int = 100  # history buffer length (T:1758)
    # cap on load-loop trips per stepper invocation (continue with resume=)
    max_trips: int = 10000
    monitor_node: int = 40  # tunnel-wall node whose u_x is recorded (T:1813)
    refine_levels: int = 0  # uniform refinements of the P1 mesh
    solver: str = "dense"
    spmv_fmt: str = "slot"
    corr_mode: str = "gather"
    gs_tangent: bool = None
    predictor_ir_iters: int = 4
    residual_fmt: str = None
    dense_mode: str = "f64"  # "f64" | "mixed" (f32 Cholesky + f64 refinement)
    # precision="df32": the Newton residual runs on the assembled f64 strain
    # and force operators G/S through kernel K1 (ops/spmv.py); otherwise
    # on the matrix-free path
    assembled_cg: bool = False
    cg_tol: float = None
    cg_maxiter: int = 2000
    cg_structure: str = "while"
    cg_eta0: float = None
    cg_cap_relax: float = None
    cg_deflate: int = 0
    dtype: str = "float64"
    # reproduce the tsx reference's per-step reset of Ep_old (u40
    # -1.979449671e-3 instead of the fixed-semantics -1.979449964e-3)
    bug_compatible_ep_reset: bool = False
    mg_nu: int = 2
    mg_cycle: str = "v"
    ell_overflow_frac: float = 0.005
    support_pressure: float = 0.0
    # "native" | "df32" (utils/precision.py)
    precision: str = "native"

    def __post_init__(self):
        dtype_policy(self.precision, self.dtype)  # raises on what is not ported
        if self.cg_structure not in CG_STRUCTURES:
            raise NotImplementedError(f"TsxTunnelConfig.cg_structure={self.cg_structure!r}")
        if self.mg_cycle not in ("v", "w"):
            raise NotImplementedError(f"TsxTunnelConfig.mg_cycle={self.mg_cycle!r}")
        if self.cg_deflate < 0:
            raise ValueError("cg_deflate must be >= 0")
        if self.etype not in P_EXTRA:
            raise NotImplementedError(f"TsxTunnelConfig.etype={self.etype}: the tsx mesh "
                                      "promotes to P1, P2 or P4 triangles")
        if self.spmv_fmt not in ("slot", "ell"):
            raise NotImplementedError(f"TsxTunnelConfig.spmv_fmt={self.spmv_fmt!r}")
        if self.residual_fmt not in RESIDUAL_FMTS:
            raise NotImplementedError(f"TsxTunnelConfig.residual_fmt={self.residual_fmt!r}")
        if self.gs_tangent not in (None, True, False):
            raise ValueError(f"gs_tangent {self.gs_tangent!r} not in (None, True, False)")
        if not 0.0 <= self.ell_overflow_frac < 1.0:
            raise ValueError(f"ell_overflow_frac {self.ell_overflow_frac!r} not in [0, 1)")
        if self.solver not in ("dense", "cg", "mg", "ell"):
            raise NotImplementedError(f"TsxTunnelConfig.solver={self.solver!r}")
        if self.solver != "ell":
            self._refuse_defaults(_ELL_ONLY, "solver='ell'")
        if self.solver not in ("mg", "ell"):
            self._refuse_defaults(_MG_ONLY, "a multigrid solver")
        if self.solver == "mg":
            # the matrix-free hierarchy refines the P1 mesh (JAX
            # `models/tsx_tunnel.py:201`, `:645`)
            if self.etype != ElementType.P1:
                raise NotImplementedError("solver='mg' needs P1")
            if self.assembled_cg:
                raise NotImplementedError("assembled_cg=True with solver='mg'")
        if self.solver == "dense":
            self._refuse_defaults(_ITERATIVE_ONLY, "an iterative solver")
        elif self.precision == "native":
            self._refuse_defaults(_DF32_ONLY, "precision='df32'")
        if self.solver == "ell":
            # the ported assembled path: df32 state, a hierarchy of at least
            # two levels (refinements plus the high-order lattice)
            if self.corr_mode not in ("scatter", "gather"):
                raise ValueError(f"corr_mode {self.corr_mode!r} not in ('scatter', 'gather')")
            if self.spmv_fmt == "ell" and self.corr_mode == "scatter":
                # the JAX package fails on this pair as well: its
                # element_corr_dest reads meta.n_sb, which EllMeta lacks
                raise ValueError(
                    "spmv_fmt='ell' needs corr_mode='gather': the scatter refresh "
                    "writes into a CSR value array"
                )
            if self.etype != ElementType.P1 and self.corr_mode == "scatter":
                # the JAX package refreshes only the P1 fine operator
                # (`models/tsx_tunnel.py:594-597`); the high-order tangent is
                # never assembled
                raise ValueError("corr_mode='scatter' needs P1: at P2/P4 the fine hierarchy "
                                 "operator only preconditions")
            if self.refine_levels + P_EXTRA[self.etype] < 1:
                raise NotImplementedError("solver='ell' needs refine_levels >= 1 at P1")
            if self.precision != "df32":
                raise NotImplementedError("solver='ell' with precision='native'")
            if self.assembled_cg:
                raise NotImplementedError("assembled_cg=True with solver='ell'")
        if self.residual_fmt is not None and self.precision == "df32" and not (
                self.solver == "ell" or self.assembled_cg):
            # only these build residual operators (JAX `models/tsx_tunnel.py:496-498`)
            raise NotImplementedError(f"residual_fmt={self.residual_fmt!r} needs "
                                      "solver='ell' or assembled_cg=True")
        if self.residual_fmt is not None and self.precision == "native":
            # the JAX package's native path never reads residual_fmt
            raise NotImplementedError("residual_fmt with precision='native'")
        if self.gs_tangent:
            # the tangent S (d (G v)) needs the residual operators (CSR or
            # ELL) and a tangent that no assembled elastic operator takes
            # (`solve/newton.py:666-751`)
            if self.solver != "ell" or self.etype == ElementType.P1:
                raise NotImplementedError("gs_tangent=True needs solver='ell' at P2 or P4")
        if self.dense_mode not in ("f64", "mixed"):
            raise ValueError(f"dense_mode {self.dense_mode!r}")
        if self.dense_mode != "f64" and (self.solver != "dense" or self.precision != "native"):
            # only the native dense factorizations read dense_mode
            raise NotImplementedError("dense_mode='mixed' needs solver='dense' and "
                                      "precision='native'")
        if self.precision == "native" and self.assembled_cg:
            # the JAX package's native path never reads assembled_cg
            raise NotImplementedError("assembled_cg=True with precision='native'")

    def _refuse_defaults(self, fields: dict, needs: str) -> None:
        for name, default in fields.items():
            if getattr(self, name) != default:
                raise NotImplementedError(
                    f"TsxTunnelConfig.{name}={getattr(self, name)!r} needs {needs}")

    @property
    def gs_tangent_on(self) -> bool:
        """Whether the tangent CG operator is S (d (G v)) on the f32 heads
        of the residual operators: gs_tangent, or with None the JAX
        package's auto rule, on at P2/P4 where the CSR residual operators
        carry a tangent that no assembled elastic operator takes, and off
        on ELL residual operators (`models/tsx_tunnel.py:893-903`: the JAX
        package takes the heads of its slot layouts only).  Set True, the
        port runs it on the ELL heads as well."""
        if self.gs_tangent is not None:
            return self.gs_tangent
        return (self.solver == "ell" and self.etype != ElementType.P1
                and self.residual_fmt != "ell")

    @classmethod
    def fast(cls, **kw):
        """Double-float preset: f64 state and residual, f32 tangent solves
        (explicit elastic inverse, Woodbury plastic solves) — the
        reference's 1e-12/1e-10 tolerances and 17/28 trajectory."""
        kw.setdefault("dtype", "float32")
        kw.setdefault("precision", "df32")
        return cls(**kw)

    @classmethod
    def fast_f32(cls, **kw):
        """Pure-f32 preset: the return map in kernel K2, f32 Cholesky with
        elastic-factor reuse, tolerances at the f32 criterion floor."""
        kw.setdefault("dtype", "float32")
        kw.setdefault("newton_tol", 1e-6)
        kw.setdefault("accept_tol", 1e-5)
        return cls(**kw)

    @classmethod
    def fast_scale(cls, refine_levels: int, **kw):
        """Large-mesh df32 preset: inexact-Newton tangent solves by CG at
        cg_tol 1e-5, preconditioned by a geometric multigrid V-cycle on
        assembled operators (solver="ell"), with the static-structure
        tangent refresh, 3 refinement passes of the elastic predictor and
        Eisenstat-Walker forcing from 1e-2.  With spmv_fmt="ell" pass
        corr_mode="gather" too: the refresh needs the CSR format."""
        kw.setdefault("solver", "ell")
        kw.setdefault("cg_tol", 1e-5)
        kw.setdefault("cg_maxiter", 200)
        kw.setdefault("corr_mode", "scatter")
        kw.setdefault("predictor_ir_iters", 3)
        kw.setdefault("cg_eta0", 1e-2)
        return cls.fast(refine_levels=refine_levels, **kw)


# fields that only the footing's iterative tangent solves (solver="cg")
# read: with the dense solver only their defaults are accepted
_FOOTING_CG_ONLY = dict(cg_eta0=None, cg_tol=None, cg_maxiter=2000, cg_cap_relax=None,
                        cg_deflate=0, cg_structure="while")
# the footing's element types: the structured square meshes of
# `mesh.structured.square_mesh`
FOOTING_ETYPES = (ElementType.P1, ElementType.P2, ElementType.Q1, ElementType.Q2)


@dataclass(frozen=True)
class FootingConfig:
    """Drucker-Prager strip footing (`Plasticity2D_DP/pythonFEM.py:901-1157`).

    Ported, for P1, P2, Q1 and Q2 elements: the dense solver in native f64
    and f32 and in "df32" (`fast()`), and `solver="cg"` (block-Jacobi
    preconditioned CG tangent solves, matrix-free) in native precision and
    in df32, where `assembled_cg=True` runs CG on the assembled elastic
    operator refreshed from every integration point once per Newton
    iteration (kernel K3), and `tangent_mg=True` (`fast_scale`)
    preconditions it with a multigrid V-cycle whose every level is
    refreshed from the consistent tangent once per Newton iteration
    (kernels K3 and K4; P1 only, as in the JAX package).  `residual_fmt`
    ("slot", "rslot": the port's CSR) is read where the JAX package reads
    it, by the df32 assembled routes.  `cg_structure="scan"` runs every CG
    solve as fixed trips.  `cg_deflate` recycles a Krylov deflation basis
    across the CG solves, `newton_damping` halves a Newton step while the
    residual norm grows.
    """

    etype: ElementType = ElementType.P1
    level: int = 1
    young: float = 1e7
    poisson: float = 0.48
    cohesion: float = 450.0
    friction_angle: float = float(np.pi / 9)
    size_xy: float = 10.0
    d_zeta: float = 1e-3
    d_zeta_min_ratio: float = 1.0 / 1300.0
    zeta_max: float = 1.0
    newton_maxit: int = 25
    newton_tol: float = 1e-12
    accept_tol: float = 1e-10
    max_steps: int = 1000  # history buffer length (P:1013)
    # cap on load-loop trips per stepper invocation
    max_trips: int = 10000
    solver: str = "dense"  # "dense" | "cg"
    # solver="cg" with precision="df32": CG on the assembled operator,
    # refreshed from all integration points once per Newton iteration
    assembled_cg: bool = False
    # solver="cg" with precision="df32", P1, level >= 2: the tangent
    # multigrid, a red-refinement hierarchy of the level-1 mesh whose every
    # level is refreshed from the consistent tangent once per Newton
    # iteration; the problem runs on the hierarchy's fine mesh (the lattice
    # and triangulation of square_mesh(level), fine-RCM node order)
    tangent_mg: bool = False
    dense_mode: str = "f64"  # "f64" | "mixed" (f32 Cholesky + f64 refinement)
    # Eisenstat-Walker forcing ceiling of the df32 CG tangent solves
    cg_eta0: float = None
    # CG tolerance; None: 1e-14 (native f64) or 2e-7 (f32 and df32)
    cg_tol: float = None
    cg_maxiter: int = 2000
    cg_structure: str = "while"
    # accept a capped CG solve whose preconditioned residual fell by this
    # factor; None: a capped solve counts as divergence (tangent_mg: 1e-2)
    cg_cap_relax: float = None
    # size of the recycled deflation basis of the CG tangent solves (A-DEF2,
    # `solve.cg.solve_cg` deflate); 0: off
    cg_deflate: int = 0
    # halvings of a Newton step while the free-DOF residual norm does not
    # fall (`solve.newton.build_load_stepper`); 0: the undamped iteration
    newton_damping: int = 0
    residual_fmt: str = None
    # reproduce the reference's apex plastic strain from the trial strain
    # (reference defect #2, SURVEY.md §2.3) for bit-level comparisons
    bug_compatible_apex: bool = False
    dtype: str = "float64"
    # "native" | "df32" (utils/precision.py)
    precision: str = "native"

    def __post_init__(self):
        dtype_policy(self.precision, self.dtype)  # raises on what is not ported
        if self.etype not in FOOTING_ETYPES:
            raise NotImplementedError(f"FootingConfig.etype={self.etype}")
        if self.cg_structure not in CG_STRUCTURES:
            raise NotImplementedError(f"FootingConfig.cg_structure={self.cg_structure!r}")
        if self.residual_fmt is not None:
            # read by the df32 assembled routes only (JAX
            # `models/footing.py:297-313`); "ell" is the tsx's
            if self.residual_fmt not in ("slot", "rslot"):
                raise NotImplementedError(f"FootingConfig.residual_fmt={self.residual_fmt!r}")
            if not (self.solver == "cg" and self.precision == "df32"
                    and (self.assembled_cg or self.tangent_mg)):
                raise NotImplementedError("residual_fmt needs solver='cg', precision='df32' "
                                          "and assembled_cg or tangent_mg")
        if self.dense_mode not in ("f64", "mixed"):
            raise ValueError(f"dense_mode {self.dense_mode!r}")
        if self.solver == "dense":
            for name, default in _FOOTING_CG_ONLY.items():
                if getattr(self, name) != default:
                    raise NotImplementedError(
                        f"FootingConfig.{name}={getattr(self, name)!r} with solver='dense'"
                    )
        elif self.solver != "cg":
            raise NotImplementedError(f"FootingConfig.solver={self.solver!r}")
        if self.dense_mode != "f64" and (self.solver != "dense" or self.precision != "native"):
            # only the native dense factorizations read dense_mode
            raise NotImplementedError("dense_mode='mixed' needs solver='dense' and "
                                      "precision='native'")
        if self.assembled_cg and (self.solver != "cg" or self.precision != "df32"):
            # the JAX package asserts solver="cg", and its native path never
            # reads assembled_cg
            raise NotImplementedError("assembled_cg=True needs solver='cg' and precision='df32'")
        if self.cg_eta0 is not None and self.precision != "df32":
            # the JAX package's native footing never passes cg_eta0 on
            raise NotImplementedError("cg_eta0 with precision='native'")
        if self.tangent_mg:
            # the JAX package's asserts (models/footing.py build_df32)
            if self.solver != "cg" or self.precision != "df32" or self.assembled_cg:
                raise NotImplementedError("tangent_mg=True needs solver='cg', "
                                          "precision='df32' and assembled_cg=False")
            if self.level < 2:
                raise ValueError("tangent_mg needs level >= 2: at least one refinement")
            if self.etype != ElementType.P1:
                # the JAX package's tangent hierarchy is a P1 hierarchy
                # (`solve/multigrid.py:493` asserts n_q == 1)
                raise NotImplementedError("tangent_mg needs P1")
        if self.cg_deflate < 0 or self.newton_damping < 0:
            raise ValueError("cg_deflate and newton_damping must be >= 0")
        if (self.cg_deflate or self.newton_damping) and self.precision != "df32":
            # ported and held to the JAX package on the df32 scale path
            raise NotImplementedError("cg_deflate and newton_damping need precision='df32'")

    @classmethod
    def fast(cls, **kw):
        """Double-float preset: f64 state and residual, f32 tangent solves
        (the dense solver's explicit Jacobi-scaled elastic inverse and f32
        Cholesky factors, or f32 CG).  newton_tol sits at the df32
        criterion floor of this near-incompressible problem, so the
        pressure-doubling rule fires where the f64 run's 1e-12 does: the
        dense preset follows the f64 schedule (16 steps)."""
        kw.setdefault("dtype", "float32")
        kw.setdefault("precision", "df32")
        kw.setdefault("newton_tol", 5e-12)
        return cls(**kw)

    @classmethod
    def fast_f32(cls, **kw):
        """Pure-f32 preset: the return map in kernel K2, f32 Cholesky with
        elastic-factor reuse, tolerances at the f32 criterion floor.  The
        adaptive schedule may differ from the f64 one; the limit pressure
        agrees to ~1e-4."""
        kw.setdefault("dtype", "float32")
        kw.setdefault("newton_tol", 1e-6)
        kw.setdefault("accept_tol", 1e-5)
        return cls(**kw)

    @classmethod
    def fast_scale(cls, level: int, **kw):
        """Tangent-multigrid scale preset (level >= 2): CG tangent solves
        preconditioned by the tangent V-cycle, Eisenstat-Walker forcing from
        1e-2, capped solves accepted at a 1e-2 reduction, a recycled
        16-vector deflation basis, and the tolerances newton 1e-10 / accept
        1e-8 (the reference's 1e-12 / 1e-10 are out of reach of f32
        preconditioned solves at this size).  From level 5 on the Newton
        step is damped (3 halvings): the undamped iteration oscillates
        between active sets at the sharply resolved plastic front."""
        kw.setdefault("solver", "cg")
        kw.setdefault("tangent_mg", True)
        kw.setdefault("cg_maxiter", 3000)
        kw.setdefault("cg_eta0", 1e-2)
        kw.setdefault("newton_tol", 1e-10)
        kw.setdefault("accept_tol", 1e-8)
        kw.setdefault("cg_deflate", 16)
        kw.setdefault("newton_damping", 3 if level >= 5 else 0)
        return cls.fast(level=level, **kw)
