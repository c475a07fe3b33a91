"""PyTorch port: the TSX tunnel's high-order path (P2 and P4 elements).

The port's promotion, its residual operators, the assembled elastic K and
the f32 elastic operator on the heads of G and S are held to the JAX
package's (its slot kernels in interpret mode, as `tests/test_spmv.py`
runs them), the p-multigrid node match to the JAX package's permutation,
and the routes to the JAX package's runs read from the fixtures that
`tools/make_port_fixtures.py` writes (`tsx_p2_*_z2`: P2 cut at zeta 2/17,
`tsx_p4_*_z1`: P4 cut at 1/17, both elastic; `tsx_p2_pmg_*_z17`: P2 at the
full schedule, plastic from load step 11), each built from the
configuration its fixture stores: steps and plastic points equal, Newton
iterations by trip equal or fewer at the two-float floor
(`footing.newton_trip_gaps`), CG within 5%, u within 1e-9 relative (the
tolerance the JAX package's own tests hold these routes to one another
with).  The P4 routes but the production one (p-multigrid with
gs_tangent), the P4 plastic cuts and the other P2 routes at the full
schedule cost 10-75 s each here and are held to their fixtures on the
card, in `chip_smoke.py`.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from fem_elastoplasticity_tpu.mesh import midpoints as jmid
from fem_elastoplasticity_tpu.mesh import refine as jrefine
from fem_elastoplasticity_tpu.models import tsx_tunnel as jtsx
from fem_elastoplasticity_tpu.models.config import TsxTunnelConfig as JaxConfig
from fem_elastoplasticity_tpu.ops import assembly_df as jadf
from fem_elastoplasticity_tpu.ops import elements as jel
from fem_elastoplasticity_tpu.ops import spmv as jspmv
from fem_elastoplasticity_tpu_torch.mesh import midpoints as pmid
from fem_elastoplasticity_tpu_torch.mesh import refine as prefine
from fem_elastoplasticity_tpu_torch.models import footing
from fem_elastoplasticity_tpu_torch.models import tsx_tunnel as tsx
from fem_elastoplasticity_tpu_torch.models.config import TsxTunnelConfig
from fem_elastoplasticity_tpu_torch.models.materials import lame_moduli
from fem_elastoplasticity_tpu_torch.ops import assembly as pasm
from fem_elastoplasticity_tpu_torch.ops import assembly_df as padf
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.ops.elements import ElementType, volume_element
from fem_elastoplasticity_tpu_torch.solve.newton import carry_of
from fem_elastoplasticity_tpu_torch.utils.convert import (carry_from_jax, carry_to_jax,
                                                         geometry_from_df, load_checkpoint)

# small tensors: extra threads only contend with the other test workers
torch.set_num_threads(1)

FIXTURES = pathlib.Path(__file__).resolve().parent / "fixtures" / "torch_port"
SHEAR, BULK = lame_moduli(60000.0, 0.2)
def rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max() / np.abs(np.asarray(b)).max())


def fixture(name: str) -> dict:
    return dict(np.load(FIXTURES / f"{name}.npz"))


def fixture_names(pattern: str) -> list:
    return sorted(f.stem for f in FIXTURES.glob(f"{pattern}.npz"))


def route_of(name: str) -> str:
    """tsx_p2_pmg_gs_z2 -> pmg_gs"""
    return name.split("_", 2)[2].rsplit("_", 1)[0]


def config_of(want: dict, **kw) -> TsxTunnelConfig:
    """The configuration of a fixture's JAX run (its `config`: etype, the
    load steps of the cut, the route's keywords), in the port."""
    c = json.loads(want["config"].item())
    route = {k: v for k, v in c.items() if k not in ("etype", "steps", "route")}
    return TsxTunnelConfig(etype=ElementType[c["etype"]], zeta_max=c["steps"] / 17,
                           **route, **kw)


# ---------------------------------------------------------------------------
# host setup against the JAX package
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("refine", [0, 1])
@pytest.mark.parametrize("et", ["P2", "P4"])
def test_promote_equals_jax(et, refine):
    base = jtsx.tsx_mesh(jel.ElementType.P1)
    coords, elems = base.coords, base.elems
    for _ in range(refine):
        pc, pe = prefine.refine_uniform(coords, elems)
        coords, elems = jrefine.refine_uniform(coords, elems)
        np.testing.assert_array_equal(pc, coords)
        np.testing.assert_array_equal(pe, elems)
    jc, je = jmid.promote(jel.ElementType[et], coords, elems)
    pc, pe = pmid.promote(ElementType[et], coords, elems)
    np.testing.assert_array_equal(pc, jc)
    np.testing.assert_array_equal(pe, je)
    assert pe.dtype == je.dtype
    jm, pm = jtsx.tsx_mesh(jel.ElementType[et], refine), tsx.tsx_mesh(ElementType[et], refine)
    np.testing.assert_array_equal(pm.coords, jm.coords)
    np.testing.assert_array_equal(pm.elems, jm.elems)
    np.testing.assert_array_equal(pm.free, jm.free)


def test_mesh_sizes():
    """The high-order mesh sizes: P2 and P4 on the tsx mesh, and the two
    228,112-DOF meshes on the P1 refine-4 lattice."""
    for et, refine, nodes, free in (("P2", 0, 1839, 3594), ("P4", 0, 7226, 14288),
                                    ("P4", 2, 114056, 227468), ("P2", 3, 114056, 227468)):
        m = tsx.tsx_mesh(ElementType[et], refine)
        assert (m.n_nodes, int(m.free.sum())) == (nodes, free), (et, refine)


def _split(x64):
    hi = x64.astype(np.float32)
    return hi, (x64 - hi.astype(np.float64)).astype(np.float32)


@pytest.fixture(scope="module", params=["P2", "P4"])
def residual_ops(request):
    """(etype, the JAX package's G/S on the tsx mesh, the port's CSR G/S on
    the same f64 geometry).  JAX's slot layout: its routes' default, rslot,
    holds the same f64 matrices in ragged chunks, whose interpret-mode
    products cost ten times as much here (the route fixtures ran on it)."""
    et = request.param
    mesh = jtsx.tsx_mesh(jel.ElementType[et])
    gdf = jadf.geometry_df(mesh.coords, mesh.elems, jel.volume_element(jel.ElementType[et]))
    jops = jspmv.build_residual_slot_df(gdf, fmt="slot")
    g = geometry_from_df(gdf.hi.B, gdf.B_lo, gdf.hi.weight, gdf.w_lo, gdf.hi.edofs,
                         gdf.hi.n_nodes, gdf.hi.n_q, gdf.hi.n_real)
    return et, jops, pspmv.residual_operators(g, "cpu"), g


def test_residual_operators_equal_jax(residual_ops):
    """G u and S s through the port's CSR (K1's plain version) against
    `sp_matvec_df` on the JAX package's slot operators, within 1e-14."""
    et, (Ga, Gm, Sa, Sm), (G, S), g = residual_ops
    rng = np.random.default_rng(3)
    u = rng.standard_normal(G.shape[1]) * 1e-3
    s = rng.standard_normal(S.shape[1])
    s[np.tile(np.arange(g.n_int) >= g.n_real * g.n_q, 3)] = 0.0  # padding points
    (uh, ul), (sh, sl) = _split(u), _split(s)
    v = rng.standard_normal(G.shape[1]).astype(np.float32)

    def products(ga, sa, a, b, c, d, x):
        out = (jspmv.sp_matvec_df(ga, Gm, a, b), jspmv.sp_matvec_df(sa, Sm, c, d))
        if et == "P2":  # the f32 elastic operator on the heads, once
            out += (jadf.elastic_apply_gs32((ga, Gm, sa, Sm), x, SHEAR, BULK),)
        return out

    (eh, el), (fh, fl), *gs = jax.jit(products)(Ga, Sa, uh, ul, sh, sl, jnp.asarray(v))
    pspmv.LAUNCHES.clear()
    e = pspmv.sp_matvec(G, torch.as_tensor(uh.astype(np.float64) + ul))
    f = pspmv.sp_matvec(S, torch.as_tensor(sh.astype(np.float64) + sl))
    assert pspmv.LAUNCHES == {"csr_spmv_f64_plain": 2}
    for got, hi, lo in ((e, eh, el), (f, fh, fl)):
        exp = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        assert np.linalg.norm(got.numpy() - exp) / np.linalg.norm(exp) <= 1e-14, et
    if gs:
        # the f32 elastic operator on the heads (the predictor's CG operator)
        exp = np.asarray(gs[0])
        G32, S32 = padf.f32_heads(G, S)
        assert G32.values.dtype == torch.float32
        got = padf.elastic_apply_gs32(G32, S32, torch.as_tensor(v), SHEAR, BULK)
        assert got.dtype == torch.float32
        assert float(np.abs(got.numpy() - exp).max() / np.abs(exp).max()) <= 1e-6


def test_assembled_elastic_k_equals_jax():
    """The P4 elastic K of the assembled route (RCM order, unit-diagonal
    constrained rows) in K3's node blocks against the JAX package's
    `build_ell_elastic(fmt="slot")` product, within 1e-6 (f32).  A P4
    vertex couples to up to 81 nodes (a P1 node to at most 9): the layout
    keeps each node's blocks whole, however many."""
    mesh = jtsx.tsx_mesh(jel.ElementType.P4)
    order = jspmv.rcm_node_order(mesh.elems, mesh.n_nodes)
    c2, e2, _ = jspmv.permute_mesh(mesh.coords, mesh.elems, order)
    free2 = np.asarray(mesh.free)[order]
    arrays, meta, K_jax = jspmv.build_ell_elastic(
        c2, e2, jel.volume_element(jel.ElementType.P4), SHEAR, BULK, free=free2, fmt="slot")
    K = pspmv.build_elastic_csr(c2, e2, volume_element(ElementType.P4), SHEAR, BULK, free=free2)
    assert (K != K_jax).nnz == 0
    B = pspmv.node_blocks(pspmv.csr_to_device(K, "cpu", np.float32))
    assert B.width == int(B.blocks_per_node().max()) == 81
    v = np.random.default_rng(4).standard_normal(K.shape[0]).astype(np.float32)
    exp = np.asarray(jax.jit(lambda a, x: jspmv.sp_matvec(a, meta, x))(arrays, jnp.asarray(v)))
    got = pspmv.sp_matvec(B, torch.as_tensor(v)).numpy()
    assert float(np.abs(got - exp).max() / np.abs(exp).max()) <= 1e-6


# ---------------------------------------------------------------------------
# the routes against the JAX package's runs
# ---------------------------------------------------------------------------
def check_route(want: dict, res, r, cfg) -> None:
    """A port run (its LoadSteppingResult `res` or None, its TsxResult `r`)
    against the fixture `want` of the same route."""
    assert r.n_steps == int(want["n_steps"]) == round(17 * cfg.zeta_max)
    assert r.n_plastic == int(want["n_plastic"])
    if res is None:  # native f64: the JAX native run records no trips
        assert r.n_newton_total == int(want["n_newton_total"])
    else:
        assert footing.newton_trip_gaps(res, want["newton_trips"], cfg) == []
    n_cg = int(want["n_cg_total"])
    assert abs(r.n_cg_total - n_cg) <= 0.05 * n_cg, (r.n_cg_total, n_cg)
    assert r.u.shape == want["u"].shape and r.ep.shape == want["ep"].shape
    assert rel(r.u, want["u"]) < 1e-9
    assert rel(r.displ_hist[: r.n_steps], want["displ_hist"][: r.n_steps]) < 1e-9


def run_df32(cfg):
    extras = {}
    run, mesh = tsx.build_df32(cfg, device="cpu", extras=extras)
    res = run()
    return res, tsx._df32_result(res, mesh, extras), extras


def check_pmg_launches(launches: dict, r, cfg) -> None:
    """The P1 lattice hierarchy preconditions: K4 and K3's transfers; the
    predictor (and with gs_tangent the tangent) on the f32 heads of G and S
    through K3's CSR kernel; no fine-level product."""
    assert launches["block_jacobi_sweep_plain"] > 0 and launches["node_transfer_plain"] > 0
    assert "node_block_spmv_plain" not in launches
    assert launches["csr_spmv_f32_plain"] >= 2 * r.n_cg_total * cfg.gs_tangent_on


@pytest.mark.parametrize("name", fixture_names("tsx_p2_*_z2"), ids=route_of)
def test_p2_route_matches_jax(name):
    want = fixture(name)
    cfg = config_of(want)
    pspmv.LAUNCHES.clear()
    if cfg.precision == "native":
        res, r = None, tsx.solve(cfg, device="cpu")
    else:
        res, r, extras = run_df32(cfg)
    launches = dict(pspmv.LAUNCHES)
    check_route(want, res, r, cfg)
    assert r.n_plastic == 0  # the cut is elastic
    if cfg.solver == "cg" and not cfg.assembled_cg:
        assert not launches  # matrix-free
    elif cfg.assembled_cg:
        # K3's product (CG, criterion) and K1 (residual), the plain versions
        assert launches["node_block_spmv_plain"] >= r.n_cg_total
        assert launches["csr_spmv_f64_plain"] > 0
    else:
        check_pmg_launches(launches, r, cfg)
        assert cfg.gs_tangent_on == (route_of(name) == "pmg_gs")


@pytest.mark.parametrize("name", fixture_names("tsx_p2_pmg_*_z17"), ids=route_of)
def test_p2_plastic_schedule_matches_jax(name):
    """P2 on the p-multigrid routes at the full schedule, plastic from load
    step 11: the tangent with plastic points, matrix-free on the f32
    geometry (pmg_mf, the tangent of the df32 matrix-free routes) or
    S32 (d (G32 v)) (pmg_gs), against the JAX package's runs."""
    want = fixture(name)
    cfg = config_of(want)
    pspmv.LAUNCHES.clear()
    res, r, _ = run_df32(cfg)
    check_pmg_launches(dict(pspmv.LAUNCHES), r, cfg)
    check_route(want, res, r, cfg)
    assert r.n_plastic > 0 and max(res.newton_trips) > 1


def test_p2_native_cg_matches_dense():
    """The native PCG route and the dense solver on the same P2 problem
    (the dense one's f64 Cholesky), within CG's 1e-14 tolerance."""
    r_cg = tsx.solve(config_of(fixture("tsx_p2_native_z2")), device="cpu")
    r_dense = tsx.solve(TsxTunnelConfig(etype=ElementType.P2, zeta_max=2 / 17), device="cpu")
    assert r_dense.n_steps == r_cg.n_steps == 2
    assert rel(r_cg.u, r_dense.u) < 1e-11


def test_pmg_node_match_equals_jax():
    """The p-multigrid route's node order (the P1 lattice matched by
    coordinates) and element sort equal the JAX package's, at P2 and P4."""
    for et in ("P2", "P4"):
        jex, pex = {}, {}
        jtsx.build_df32(JaxConfig.fast(etype=jel.ElementType[et], solver="ell"), extras=jex)
        tsx.build_df32(TsxTunnelConfig.fast(etype=ElementType[et], solver="ell"), device="cpu",
                       extras=pex)
        np.testing.assert_array_equal(pex["ell_new_of_old"], jex["ell_new_of_old"])
        np.testing.assert_array_equal(pex["elem_sort"][0], jex["elem_sort"][0])
        assert pex["elem_sort"][1:] == tuple(jex["elem_sort"][1:])


@pytest.fixture(scope="module")
def p4_pmg():
    """The P4 production route (p-multigrid, gs_tangent auto) built for two
    load steps and run one trip a call: its first trip is the fixture's
    cut, its carry resumes the second."""
    cfg = TsxTunnelConfig.fast(etype=ElementType.P4, solver="ell", zeta_max=2 / 17, max_trips=1)
    extras = {}
    run, mesh = tsx.build_df32(cfg, device="cpu", extras=extras)
    res = run()
    return cfg, run, mesh, extras, res


def test_p4_production_route_matches_jax(p4_pmg):
    cfg, _, mesh, extras, res = p4_pmg
    assert cfg.gs_tangent_on
    r = tsx._df32_result(res, mesh, extras)
    want = fixture("tsx_p4_pmg_gs_z1")
    check_route(want, res, r, config_of(want))
    assert r.u.shape == (7226, 2) and r.ep.shape[1] >= 887 * 12


def test_p4_carry_round_trips_and_a_jax_carry_resumes(p4_pmg, tmp_path):
    """The JAX package's P4 carry after its first trip (on the route's
    permuted node order, `tsx_p4_pmg_carry1`) goes through carry_from_jax
    and carry_to_jax with its keys, types, shapes, heads and scalars
    unchanged, each two-float pair's value within the 48 bits a pair holds
    of the f64 between (an unnormalized pair can hold bits an f64 rounds
    off); the port's carry goes through carry_to_jax and back within those
    48 bits; and the JAX carry resumes in the port, its second trip equal
    to the port's own from its own carry."""
    cfg, run, mesh, extras, res = p4_pmg
    path = FIXTURES / "tsx_p4_pmg_carry1.npz"
    with np.load(path) as raw:
        files = {k: raw[k] for k in raw.files}
    back = carry_to_jax(carry_from_jax(files))
    assert back.keys() == files.keys()
    for k, v in files.items():
        assert back[k].dtype == v.dtype and back[k].shape == v.shape, k
        if not k.endswith("__lo"):
            np.testing.assert_array_equal(back[k], v, err_msg=k)
    for k in (k[:-4] for k in files if k.endswith("__hi")):
        pair = lambda c: c[k + "__hi"].astype(np.float64) + c[k + "__lo"]  # noqa: E731
        scale = max(float(np.abs(pair(files)).max()), 1e-300)
        assert float(np.abs(pair(back) - pair(files)).max()) <= 2.0 ** -48 * scale, k
    ours = carry_of(res)
    again = carry_from_jax(carry_to_jax(ours))
    assert again["ep"].shape == ours["ep"].shape == files["ep__hi"].shape
    for k in ("u", "u_it", "ep"):  # ep: all zero after an elastic trip
        gap = float((again[k] - ours[k]).abs().max())
        assert gap <= 2.0 ** -47 * float(ours[k].abs().max()), k

    jax_carry = load_checkpoint(path)
    assert rel(jax_carry["u"], ours["u"]) < 1e-9
    a = run(resume=ours)
    b = run(resume=jax_carry)
    assert a.n_steps == b.n_steps == 2 and a.n_newton_total == b.n_newton_total == 2
    assert rel(b.u, a.u) < 1e-9


def test_configs_accept_the_high_order_routes_and_refuse_the_rest():
    for name in fixture_names("tsx_p[24]_*_z*"):
        config_of(fixture(name))
    for et in ("P2", "P4"):
        assert TsxTunnelConfig.fast(etype=ElementType[et], solver="ell",
                                    residual_fmt="rslot").gs_tangent_on
        assert TsxTunnelConfig.fast(etype=ElementType[et], solver="ell",
                                    refine_levels=2).refine_levels == 2
    assert not TsxTunnelConfig.fast_scale(1).gs_tangent_on
    refused = [
        (dict(etype=ElementType.P2, solver="ell", gs_tangent=True), NotImplementedError),  # native
        (dict(solver="ell", gs_tangent=True), NotImplementedError),  # P1
        (dict(solver="cg", gs_tangent=True), NotImplementedError),
        (dict(etype=ElementType.Q1), NotImplementedError),
        # the matrix-free multigrid refines the P1 mesh only
        (dict(solver="mg", etype=ElementType.P2), NotImplementedError),
        (dict(etype=ElementType.P4, solver="cg", cg_eta0=1e-2), NotImplementedError),
        (dict(etype=ElementType.P4, solver="cg", residual_fmt="rslot"), NotImplementedError),
    ]
    for kw, exc in refused:
        with pytest.raises(exc):
            TsxTunnelConfig(**kw)
    # the ELL residual operators at P2/P4: the JAX package's auto rule runs
    # the tangent matrix-free there; gs_tangent=True takes their f32 heads
    ell = TsxTunnelConfig.fast(solver="ell", etype=ElementType.P4, residual_fmt="ell")
    assert not ell.gs_tangent_on
    assert TsxTunnelConfig.fast(solver="ell", etype=ElementType.P4, gs_tangent=True,
                                residual_fmt="ell").gs_tangent_on
    for kw, exc in [
        (dict(solver="ell", etype=ElementType.P4, corr_mode="scatter"), ValueError),
        (dict(solver="mg", etype=ElementType.P4), NotImplementedError),
        (dict(solver="mg", assembled_cg=True), NotImplementedError),
        (dict(solver="cg", residual_fmt="ell"), NotImplementedError),  # matrix-free
        (dict(solver="cg", assembled_cg=True, mg_nu=3), NotImplementedError),
    ]:
        with pytest.raises(exc):
            TsxTunnelConfig.fast(**kw)
