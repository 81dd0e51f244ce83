"""K5's set-up and its bound launch on the CPU (mycelium_tpu_torch/
kernels/chain_cg.py, fea/coarse.py):

- ``chain_cg_setup_plain`` against a numpy emulation of the kernel's
  set-up order (tests/torch_support.py::emulate_chain_setup), bit for bit:
  const and linear basis, one and several blocks a cluster, intact and 5%
  fractured with the islands pinned;
- the fixed-order coarse assembly (``CoarsePlan``, ``coarse_matrix``) and
  the Gauss-Jordan inverse of its normalisation against the JAX package's
  ``_coarse_matrix_chain`` / ``_coarse_inverse`` in float64
  (tests/torch_support.py::jax_coarse_in_float64): the matrix to 1e-12 of
  its largest entry, the inverse to 1e-10 (no pivoting against LAPACK's
  partial pivoting: the difference is the inverse's own float64 error);
- ``ChainCgLaunch`` on the CPU: two consecutive solves with different
  masks and loads equal two fresh plain solves; ``solve_displacement``
  goes through the model's launch; the barrier rule and the scratch
  layout.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mycelium_tpu.config import FeaConfig as JaxConfig
from mycelium_tpu.fea import pallas_cg
from mycelium_tpu.fea.model import build_model as jbuild
from mycelium_tpu_torch.config import FeaConfig
from mycelium_tpu_torch.fea import coarse
from mycelium_tpu_torch.fea.chain_solve import chain_cg_inputs
from mycelium_tpu_torch.fea.model import build_model
from mycelium_tpu_torch.fea.ramp import anchored_mask_host
from mycelium_tpu_torch.fea.solve import solve_displacement
from mycelium_tpu_torch.kernels import ChainCgLaunch, chain_cg_plain
from mycelium_tpu_torch.kernels import chain_cg as ccg
from tests.torch_support import (emulate_chain_setup, grip_for,
                                 jax_coarse_in_float64, random_forest_mesh,
                                 rel_err, synthetic_mesh)


def _case(mesh, frac, seed, dtype="float32", **kw):
    coords, conn = mesh
    cfg = FeaConfig(dtype=dtype, operator="chain", precond="coarse",
                    grip_length=grip_for(coords), rtol=1e-5, max_iter=3000,
                    warm_start=False, **kw)
    m = build_model(coords, conn, cfg, "cpu")
    rng = np.random.default_rng(seed)
    act = rng.random(m.n_elems) >= frac
    grip = (m.top_nodes | m.bot_nodes).numpy()
    anch = anchored_mask_host(np.asarray(conn), act, grip)
    x0 = torch.as_tensor(0.001 * rng.standard_normal((m.n_nodes, 3)),
                         dtype=m.dtype)
    return m, cfg, torch.as_tensor(act), torch.as_tensor(anch), x0


@pytest.mark.parametrize("basis", ["const", "linear"])
@pytest.mark.parametrize("max_dim,frac", [(1536, 0.05), (9, 0.0)])
def test_setup_is_the_kernels_order(basis, max_dim, frac):
    m, cfg, act, anch, x0 = _case(random_forest_mesh(600, 12, 0), frac, 1,
                                  coarse_basis=basis, coarse_max_dim=max_dim)
    out = m.chain_launch.setup(act, anch, 0.02, -0.013, x0, cfg)
    want = emulate_chain_setup(m.chain_launch, act, anch, 0.02, -0.013, x0,
                               cfg)
    assert set(out) == set(want)
    for key, ref in want.items():
        got = out[key].numpy()
        assert got.shape == ref.shape and got.dtype == ref.dtype, key
        np.testing.assert_array_equal(got, ref, err_msg=key)
    nbc, width, _ = ccg.layout_of(m.n_nodes, cfg)
    assert (width > coarse.BLOCK) == (max_dim == 9)


@pytest.mark.parametrize("basis", ["const", "linear"])
@pytest.mark.parametrize("frac", [0.0, 0.05])
def test_coarse_assembly_matches_reference_f64(basis, frac):
    coords, conn = synthetic_mesh(2000)
    kw = dict(dtype="float64", operator="chain", precond="tree",
              grip_length=grip_for(coords), coarse_basis=basis)
    mj = jbuild(coords, conn, JaxConfig(**kw))
    m = build_model(coords, conn, FeaConfig(**kw), "cpu")
    cfg = FeaConfig(**kw)
    rng = np.random.default_rng(3)
    act = rng.random(m.n_elems) >= frac
    anch = anchored_mask_host(np.asarray(conn), act,
                              (m.top_nodes | m.bot_nodes).numpy())
    free = np.asarray(m.free_nodes) & anch
    nb, kblk, nbc, width = coarse.cluster_layout(m.n_nodes, cfg)
    with jax_coarse_in_float64():
        aj = np.asarray(pallas_cg._coarse_matrix_chain(
            mj, mj.chain, jnp.asarray(act), jnp.asarray(free), cfg, nb,
            kblk))
        ij = np.asarray(pallas_cg._coarse_inverse(
            mj, mj.chain, jnp.asarray(act), jnp.asarray(free), cfg, nb,
            kblk))
    plan = m.coarse_plans.get(nbc, width, coarse.n_basis(cfg))
    a = coarse.coarse_matrix(plan, m.chain, torch.as_tensor(act),
                             torch.as_tensor(free)[m.chain.perm], cfg.reg,
                             torch.float64)
    s, an = coarse.coarse_normalize(a)
    ainv = s[:, None] * coarse.gauss_jordan(an) * s[None, :]
    assert a.shape == aj.shape and np.abs(aj).max() > 0
    assert rel_err(a.numpy(), aj) <= 1e-12
    assert rel_err(ainv.numpy(), ij) <= 1e-10


def test_consecutive_solves_equal_fresh_plain_solves():
    m, cfg, act, anch, x0 = _case(synthetic_mesh(2000), 0.05, 4)
    launch = m.chain_launch
    assert isinstance(launch, ChainCgLaunch)
    act2 = torch.ones_like(act)
    cases = [(act, anch, x0, 0.02, -0.02),
             (act2, None, torch.zeros_like(x0), 0.011, -0.017)]
    got = [launch.solve(a, an, dt, db, x, cfg) for a, an, x, dt, db in cases]
    for (a, an, x, dt, db), (xs, stats) in zip(cases, got):
        xp, sp = chain_cg_plain(*chain_cg_inputs(m, a, dt, db, x, cfg, an))
        assert xs.shape == (m.n_nodes, 3) and xs.dtype == torch.float32
        assert torch.equal(xs, xp.T[m.chain.inv_perm])
        assert stats.shape == (3,) and torch.equal(stats, sp)
        assert float(stats[1]) <= float(stats[2]) and int(stats[0]) > 10
    assert not torch.equal(got[0][0], got[1][0])
    res = solve_displacement(m, act, 0.02, -0.02, x0, cfg, anch)
    assert torch.equal(res.x, got[0][0]) and res.iters == int(got[0][1][0])


def test_barrier_rule_and_layout():
    m, cfg, _, _, _ = _case(synthetic_mesh(2000), 0.0, 5)
    nbc, width, nbas = ccg.layout_of(m.n_nodes, cfg)
    plan = m.coarse_plans.get(nbc, width, nbas)
    # one plan a layout, the model's: the launch and the PyTorch routes
    # read the same
    assert plan is m.coarse_plans.get(nbc, width, nbas)
    assert m.chain_launch.plans is m.coarse_plans
    cpu = m.chain_launch.on("cpu").plans
    assert cpu is not m.coarse_plans and torch.equal(
        cpu.get(nbc, width, nbas).blk_ent, plan.blk_ent)
    lay = m.chain_launch.layout(nbc, width, nbas)
    n, jp, nc = m.n_nodes, m.chain.ja.shape[0], plan.nc
    nblk = plan.blk_row.shape[0]
    assert lay["total"] == 21 * n + 2 * n + jp + 9 * n + nc + 9 * nblk \
        + 3 * nc * nc + nc
    offs = [v[0] for k, v in lay.items() if k != "total"]
    assert offs == sorted(offs) and offs[0] == 0
    # three barriers before the loop and one a pair of pivots, three an
    # iteration
    assert ccg.barrier_count(nc, 0) == 3 + (nc + 1) // 2
    assert ccg.barrier_count(nc, 7) - ccg.barrier_count(nc, 0) == 21
    # every cluster's diagonal block is in the plan, every position's reg
    # term once
    key = plan.blk_row.long() * nbc + plan.blk_col.long()
    assert bool((plan.blk_map[key] == torch.arange(nblk)).all())
    assert int(((plan.blk_ent & 15) == coarse.KIND_REG).sum()) == n
    cfg_lin = dataclasses.replace(cfg, coarse_basis="linear")
    assert m.coarse_plans.get(*ccg.layout_of(n, cfg_lin)).nc == 2 * nc
