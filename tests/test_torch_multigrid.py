"""PyTorch port: the assembled multigrid hierarchy and its V-cycle.

The port's `build_hierarchy_ell` is held to the JAX package's
(`fmt="slot"`, `collect_levels=True`) level by level, and one V-cycle and a
V-cycle-preconditioned CG are run in both packages on identical operators:
the JAX package's host data, carried over by
`utils.convert.hierarchy_from_numpy`.  The JAX side runs its Pallas kernels
in interpret mode, as its own tests do on the CPU.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from fem_elastoplasticity_tpu.models.materials import lame_moduli
from fem_elastoplasticity_tpu.models.tsx_tunnel import _DATA
from fem_elastoplasticity_tpu.ops import spmv as jspmv
from fem_elastoplasticity_tpu.ops.elements import ElementType, volume_element
from fem_elastoplasticity_tpu.solve import cg as jcg
from fem_elastoplasticity_tpu.solve import multigrid as jmg
from fem_elastoplasticity_tpu_torch.models.tsx_tunnel import _free_of
from fem_elastoplasticity_tpu_torch.ops import elements as pel
from fem_elastoplasticity_tpu_torch.ops import spmv as pspmv
from fem_elastoplasticity_tpu_torch.solve import cg as pcg
from fem_elastoplasticity_tpu_torch.solve import multigrid as pmg
from fem_elastoplasticity_tpu_torch.utils.convert import hierarchy_from_numpy

torch.set_num_threads(1)


def _base():
    with np.load(_DATA) as raw:
        return raw["coords"].astype(np.float64), raw["elems"]


_CACHE = {}


def _hierarchies(levels):
    """(JAX (arrays, metas, perms, coarse), port (hierarchy, perms, coarse))."""
    if levels not in _CACHE:
        shear, bulk = lame_moduli(60000.0, 0.2)
        coords, elems = _base()
        j = jmg.build_hierarchy_ell(
            coords, elems, levels, _free_of, shear, bulk, volume_element(ElementType.P1),
            fmt="slot", collect_levels=True)
        p = pmg.build_hierarchy_ell(
            coords, elems, levels, _free_of, shear, bulk, pel.volume_element(pel.ElementType.P1),
            device="cpu")
        _CACHE[levels] = (j, p)
    return _CACHE[levels]


def _same_csr(a, b):
    a, b = a.tocsr(), b.tocsr()
    a.sort_indices()
    b.sort_indices()
    np.testing.assert_array_equal(a.indptr, b.indptr)
    np.testing.assert_array_equal(a.indices, b.indices)
    np.testing.assert_array_equal(a.data, b.data)


@pytest.mark.parametrize("levels", [1, 2])
def test_hierarchy_equals_jax(levels):
    (jarr, jmeta, jperms, jcoarse), (hier, perms, coarse) = _hierarchies(levels)
    assert len(hier.levels) == len(jarr) == levels + 1
    for l, (lev, host, ja, jl) in enumerate(
            zip(hier.levels, coarse["levels"], jarr, jcoarse["levels"])):
        np.testing.assert_array_equal(perms[l], jperms[l])
        _same_csr(host["K"], jl["K"])
        np.testing.assert_array_equal(host["free"], jl["free"])
        np.testing.assert_array_equal(host["coords"], jl["coords"])
        np.testing.assert_array_equal(host["elems"], jl["elems"])
        np.testing.assert_array_equal(lev.inv.numpy(), np.asarray(ja["inv"]))
        np.testing.assert_array_equal(lev.free.numpy(), np.asarray(ja["free"]))
        # the device operator is the host CSR rounded to f32, entry for
        # entry, in node blocks on every level; the fine level's f32 blocks
        # are also CG's operator, and no level keeps a CSR on the device
        K32 = host["K"].astype(np.float32)
        if l == levels:
            assert lev.op is lev.sweep_op
        else:
            assert lev.op is None
        B = lev.sweep_op
        blocks = sp.bsr_matrix((B.block_values.numpy().reshape(-1, 2, 2), B.block_cols.numpy(),
                                B.node_ptr.numpy()), shape=B.shape)
        assert (blocks != K32).nnz == 0
        if l == 0:
            assert host["P"] is None and lev.P is None and lev.R is None
        else:
            _same_csr(host["P"], jl["P"])
            assert lev.P.shape == (lev.free.shape[0], hier.levels[l - 1].free.shape[0])
            assert lev.R.shape == lev.P.shape[::-1]
            assert set(np.unique(lev.P.weights.numpy())) <= {0.5, 1.0}
            # node transfers times I_2 are the host P and R in f32
            P32 = host["P"].astype(np.float32)
            for T, want in ((lev.P, P32), (lev.R, P32.T.tocsr())):
                nodes = sp.csr_matrix((T.weights.numpy(), T.node_cols.numpy(),
                                       T.node_ptr.numpy()),
                                      shape=(T.shape[0] // 2, T.shape[1] // 2))
                assert (sp.kron(nodes, sp.eye(2, dtype=np.float32)) != want).nnz == 0
    np.testing.assert_array_equal(hier.inv0.numpy(), np.asarray(jcoarse["inv0"]))
    np.testing.assert_array_equal(hier.free_idx0.numpy(), np.asarray(jcoarse["free_idx0"]))
    _same_csr(coarse["fine_K"], jcoarse["fine_K"])
    np.testing.assert_array_equal(coarse["fine_free"], jcoarse["fine_free"])
    np.testing.assert_array_equal(coarse["fine_coords"], jcoarse["fine_coords"])


def _jax_vcycle(jarr, jmeta, jcoarse, nu=2):
    idx0 = jcoarse["free_idx0"]

    def coarse_solve(r):
        return jnp.zeros_like(r).at[idx0].set(jcoarse["inv0"] @ r[idx0])

    vc = jmg.make_vcycle_ell(jmeta, coarse_solve, nu=nu)
    return jax.jit(lambda r: vc(jarr, r))


def _carried(levels):
    """The JAX hierarchy's host data as the port's device hierarchy."""
    (jarr, _, _, jcoarse), _ = _hierarchies(levels)
    host = [dict(lv, inv=np.asarray(a["inv"])) for lv, a in zip(jcoarse["levels"], jarr)]
    return hierarchy_from_numpy(host, jcoarse["inv0"], jcoarse["free_idx0"], device="cpu")


@pytest.mark.parametrize("levels", [1, 2])
def test_vcycle_matches_jax(levels):
    (jarr, jmeta, _, jcoarse), _ = _hierarchies(levels)
    hier = _carried(levels)
    n = hier.levels[-1].op.shape[0]
    r = np.random.default_rng(levels).standard_normal(n).astype(np.float32)
    exp = np.asarray(_jax_vcycle(jarr, jmeta, jcoarse)(jnp.asarray(r)))
    pspmv.LAUNCHES.clear()
    got = pmg.make_vcycle_ell(hier, nu=2)(torch.as_tensor(r)).numpy()
    # nu = 2: per level above the coarsest 1 + 1 + 2 K4 calls and R, P,
    # each transfer one call with its mask (and add)
    assert pspmv.LAUNCHES == {"block_jacobi_sweep_plain": 4 * levels,
                              "node_transfer_plain": 2 * levels}
    assert np.abs(got - exp).max() <= 2e-5 * np.abs(exp).max()
    assert (got[~np.asarray(hier.levels[-1].free)] == 0).all()


def test_vcycle_is_symmetric_and_positive():
    """A V-cycle with equal pre- and post-smoothing is an SPD operator on
    the free subspace: what makes it a valid CG preconditioner."""
    hier = _carried(1)
    vc = pmg.make_vcycle_ell(hier, nu=2)
    rng = np.random.default_rng(7)
    free = hier.levels[-1].free
    a = torch.as_tensor(rng.standard_normal(free.shape[0]).astype(np.float32)) * free
    b = torch.as_tensor(rng.standard_normal(free.shape[0]).astype(np.float32)) * free
    ab, ba = float(a @ vc(b)), float(b @ vc(a))
    assert abs(ab - ba) <= 1e-4 * max(abs(ab), abs(ba))
    assert float(a @ vc(a)) > 0.0


def test_vcycle_preconditioned_cg_matches_jax():
    """V-cycle-preconditioned CG on the level-2 elastic system (14,452
    DOFs): the JAX package's iteration count +-1, and a solved system."""
    (jarr, jmeta, _, jcoarse), _ = _hierarchies(2)
    hier = _carried(2)
    fine = hier.levels[-1]
    free = fine.free.numpy()
    b = (np.random.default_rng(3).standard_normal(free.shape[0]) * free).astype(np.float32)
    jpre = _jax_vcycle(jarr, jmeta, jcoarse)
    rj = jcg.solve_cg(
        lambda v: jspmv.sp_matvec(jarr[-1]["op"], jmeta[-1]["op"], v), jnp.asarray(b),
        jnp.asarray(free), precond=jpre, tol=1e-5, maxiter=40)
    rp = pcg.solve_cg(
        lambda v: pspmv.sp_matvec(fine.op, v), torch.as_tensor(b), fine.free,
        precond=pmg.make_vcycle_ell(hier, nu=2), tol=1e-5, maxiter=40)
    assert rp.converged and bool(rj.converged)
    assert abs(rp.iters - int(rj.iters)) <= 1 and rp.iters <= 25
    x = np.asarray(rj.x)
    assert np.abs(rp.x.numpy() - x).max() <= 1e-4 * np.abs(x).max()
    Kx = _hierarchies(2)[1][2]["fine_K"] @ rp.x.numpy().astype(np.float64)
    assert np.abs((Kx - b) * free).max() <= 2e-4 * np.abs(b).max()


def test_level_of_half_a_million_rows_raises():
    """The packing decision takes only "auto", True or False, and the
    hierarchy only the "slot" and "ell" formats: anything else raises.
    Here with the level-1 hierarchy's host data."""
    (_, _, _, jcoarse), _ = _hierarchies(1)
    host = [dict(lv, inv=np.zeros((lv["K"].shape[0] // 2, 2, 2))) for lv in jcoarse["levels"]]
    with pytest.raises(ValueError, match="pack_bf16"):
        pmg.hierarchy_to_device(host, jcoarse["inv0"], jcoarse["free_idx0"], "cpu",
                                pack_bf16="yes")
    with pytest.raises(ValueError, match="fmt"):
        pmg.hierarchy_to_device(host, jcoarse["inv0"], jcoarse["free_idx0"], "cpu", fmt="rslot")


def test_level_of_half_a_million_rows_is_packed():
    """A level of half a million rows or more is smoothed from bf16 values:
    `pack_bf16` decides, as in the JAX package; the level-1 hierarchy is
    packed only by force, and an ELL hierarchy never (the JAX package packs
    slot levels only)."""
    assert pmg.packs_bf16(500_000) and not pmg.packs_bf16(499_999)
    (_, _, _, jcoarse), _ = _hierarchies(1)
    host = [dict(lv, inv=np.zeros((lv["K"].shape[0] // 2, 2, 2))) for lv in jcoarse["levels"]]
    auto = pmg.hierarchy_to_device(host, jcoarse["inv0"], jcoarse["free_idx0"], "cpu")
    forced = pmg.hierarchy_to_device(host, jcoarse["inv0"], jcoarse["free_idx0"], "cpu",
                                     pack_bf16=True)
    ell = pmg.hierarchy_to_device(host, jcoarse["inv0"], jcoarse["free_idx0"], "cpu",
                                  pack_bf16=True, fmt="ell")
    assert all(lev.sweep_op.block_values.dtype == torch.float32 for lev in auto.levels)
    assert all(lev.sweep_op.block_values.dtype == torch.bfloat16 for lev in forced.levels)
    assert all(lev.sweep_op is None and isinstance(lev.op, pspmv.EllMatrix) for lev in ell.levels)


def test_w_cycle_raises():
    # the W-cycle is ported (tests/test_torch_tsx_options.py); a cycle the
    # JAX package does not have raises
    with pytest.raises(ValueError):
        pmg.make_vcycle_ell(_carried(1), cycle="f")
