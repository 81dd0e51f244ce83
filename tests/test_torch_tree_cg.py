"""K6's plain version (mycelium_tpu_torch/kernels/tree_cg.py, the cg + tree
route of solve_displacement below the size gate) against the TPU
kernel it replaces and against the reference's XLA tree path.

- float32, through ``solve_displacement``, against ``pallas_tree_solve``
  (B4) in Pallas interpret mode exactly as tests/test_pallas_solver.py
  runs it (random_forest_mesh(260, 8, seed=11), use_pallas=True), intact
  and 12% fractured with the islands pinned: both converge, iterations
  within ±1 and x within 1e-5 of max |x| (the same float32 algorithm with
  sums in another order; the JAX package's own bar between its two tree
  routes is 5e-4).
- float64, ``tree_cg_plain`` called directly, against the reference's XLA
  tree path with ``tree_coarse_weight=0`` and ``cg_restarts=0`` on
  synthetic_mesh(2000) and a fractured forest: x within 1e-6 (relative
  L2), iterations within ±1. The reference's path solves its trailing
  levels densely; one apply of the all-PCR factor equals the dense-tail
  factor's to 1e-12 of max |z| on the intact forest (measured 1.2e-14) and
  to 1e-9 with 12% fractured (measured 1.1e-10: fragments held only by
  the regularisation floor have block inverses of 1/reg_pc, which amplify
  the two eliminations' rounding differences).
- the route: ``model.tree_kernel`` by dtype and a memory guard forced
  small, ``solve_route`` by the solve's own preconditioner, operator and
  solver whatever configuration built the model;
  ``solve_displacement`` returns what one
  ``tree_cg_plain`` call returns; ``max_iter=1`` is not converged; the
  coarse weight does not change the answer.
- the index tables K6 reads (``TreeKernelTables``) against the plan."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mycelium_tpu.config import FeaConfig
from mycelium_tpu.fea.model import build_model as jbuild
from mycelium_tpu.fea.ramp import anchored_mask_host
from mycelium_tpu.fea.solve import solve_displacement as jsolve
from mycelium_tpu_torch.fea import model as tmodel
from mycelium_tpu_torch.fea.model import build_model as tbuild
from mycelium_tpu_torch.fea.solve import (compute_tree_factor, solve_route,
                                          solve_displacement as tsolve)
from mycelium_tpu_torch.fea.tree_factor import (tree_apply_chain_planes,
                                                tree_factor_levels)
from mycelium_tpu_torch.fea.tree_solve import tree_cg_inputs
from mycelium_tpu_torch.kernels import tree_cg_plain
from tests.torch_support import grip_for, random_forest_mesh, synthetic_mesh

F32 = dict(dtype="float32", operator="chain", grip_length=0.1, rtol=1e-6,
           precond="tree", warm_start=False)


def _case(model, frac, seed=0):
    rng = np.random.default_rng(seed)
    act = rng.random(model.n_elems) > frac
    grip = np.asarray(model.top_nodes) | np.asarray(model.bot_nodes)
    return act, anchored_mask_host(np.asarray(model.conn), act, grip)


@pytest.fixture(scope="module")
def forest_f32():
    coords, conn = random_forest_mesh(n_nodes=260, n_extra=8, seed=11)
    cfg = FeaConfig(use_pallas=True, **F32)
    mj = jbuild(coords, conn, cfg)
    assert mj.tree_packed is not None
    return cfg, mj, tbuild(coords, conn, cfg, "cpu")


@pytest.mark.parametrize("frac", [0.0, 0.12])
def test_plain_matches_the_pallas_kernel(forest_f32, frac):
    assert jax.default_backend() == "cpu"     # B4 runs in interpret mode
    cfg, mj, mt = forest_f32
    assert mt.tree_kernel and solve_route(mt, cfg) == "tree_cg"
    act, anch = _case(mj, frac)
    x0 = np.zeros((mj.n_nodes, 3), np.float32)
    rj = jsolve(mj, jnp.asarray(act), 0.01, -0.01, jnp.asarray(x0), cfg,
                jnp.asarray(anch))
    rt = tsolve(mt, torch.as_tensor(act), 0.01, -0.01, torch.as_tensor(x0),
                cfg, torch.as_tensor(anch))
    assert bool(rj.converged) and rt.converged
    assert abs(rt.iters - int(rj.iters)) <= 1
    xj = np.asarray(rj.x)
    assert rt.x.dtype == torch.float32
    assert np.abs(rt.x.numpy() - xj).max() <= 1e-5 * np.abs(xj).max()


def _f64_case(name):
    if name == "synthetic2000":
        coords, conn = synthetic_mesh(2000)
        return coords, conn, grip_for(coords), 0.0
    coords, conn = random_forest_mesh(900, 18, 4)
    return coords, conn, grip_for(coords, 0.1), 0.12


@pytest.mark.parametrize("name", ["synthetic2000", "forest900"])
def test_plain_matches_the_reference_tree_path_f64(name):
    coords, conn, grip, frac = _f64_case(name)
    cfg = FeaConfig(dtype="float64", rtol=1e-8, operator="chain",
                    precond="tree", tree_coarse_weight=0.0, cg_restarts=0,
                    tree_reg_rel=1e-7, warm_start=False, grip_length=grip)
    mj = jbuild(coords, conn, cfg)
    mt = tbuild(coords, conn, cfg, "cpu")
    assert not mt.tree_kernel            # float64 stays off the kernel
    act, anch = _case(mj, frac, seed=3)
    x0 = np.zeros((mj.n_nodes, 3))
    rj = jsolve(mj, jnp.asarray(act), 0.01, -0.01, jnp.asarray(x0), cfg,
                jnp.asarray(anch))
    x, stats = tree_cg_plain(*tree_cg_inputs(
        mt, torch.as_tensor(act), 0.01, -0.01, torch.as_tensor(x0), cfg,
        torch.as_tensor(anch)))
    iters, rnorm, tol, _ = stats.tolist()
    assert bool(rj.converged) and rnorm <= tol
    assert abs(int(iters) - int(rj.iters)) <= 1
    xj = np.asarray(rj.x)
    xt = x.T[mt.chain.inv_perm].numpy()
    assert x.dtype == torch.float64
    rel = np.linalg.norm(xt - xj) / np.linalg.norm(xj)
    assert rel < 1e-6, rel


@pytest.mark.parametrize("frac,tol", [(0.0, 1e-12), (0.12, 1e-9)])
def test_all_pcr_factor_applies_like_the_dense_tail(frac, tol):
    """One preconditioner apply: every level on PCR (what K6 factors)
    against the same plan with its trailing levels in the dense tail."""
    coords, conn = random_forest_mesh(900, 18, 4)
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree",
                    tree_reg_rel=1e-7, grip_length=grip_for(coords, 0.1))
    mt = tbuild(coords, conn, cfg, "cpu")
    plan = mt.tree
    L = len(plan.meta.level_steps)
    assert 0 < plan.meta.n_pcr < L        # the plan has a dense tail
    act, anch = _case(mt, frac, seed=5)
    act, anch = torch.as_tensor(act), torch.as_tensor(anch)
    tail = compute_tree_factor(mt, act, cfg, anch)
    assert tail.sinv is not None
    args = tree_cg_inputs(mt, act, 0.01, -0.01,
                          torch.zeros((mt.n_nodes, 3), dtype=torch.float64),
                          cfg, anch)
    d9, bel, katt = args[8:11]
    plan_all = dataclasses.replace(
        plan, meta=dataclasses.replace(plan.meta, n_pcr=-1))
    al, be, dinv, att_b, _, _ = tree_factor_levels(plan_all, d9, bel, katt,
                                                   L)
    from mycelium_tpu_torch.fea.tree_factor import TreeFactor
    allpcr = TreeFactor(alphas=al, betas=be, dinvs=dinv, att_b=att_b)
    r = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (3, mt.n_nodes)))
    z_tail = tree_apply_chain_planes(plan, tail, r)
    z_all = tree_apply_chain_planes(plan_all, allpcr, r)
    err = float((z_all - z_tail).abs().max()) / float(z_tail.abs().max())
    assert err <= tol, err


def test_gate_and_route(monkeypatch):
    coords, conn = random_forest_mesh(260, 8, 11)
    cfg = FeaConfig(**F32)
    mt = tbuild(coords, conn, cfg, "cpu")
    assert mt.tree_kernel
    assert 0 < tmodel.tree_kernel_bytes(mt) <= tmodel.TREE_KERNEL_MAX_BYTES
    assert solve_route(mt, cfg) == "tree_cg"
    for other in (dict(solver="bicgstab"), dict(solver="gmres")):
        assert solve_route(mt, dataclasses.replace(cfg, **other)) == "hybrid"
    assert solve_route(mt, dataclasses.replace(cfg, precond="coarse")) \
        == "chain_cg"
    assert solve_route(mt, dataclasses.replace(cfg, operator="ell")) == "node"
    # the route follows the solve's configuration, not the one that built
    # the model: only the dtype is a fact of the model
    for change in (dict(precond="coarse"), dict(precond="block_jacobi"),
                   dict(operator="ell")):
        other = dataclasses.replace(cfg, **change)
        m = tbuild(coords, conn, other, "cpu")
        assert m.tree_kernel, change
        assert solve_route(m, cfg) == "tree_cg"
        assert solve_route(m, other) == solve_route(mt, other) != "tree_cg"
    m64 = tbuild(coords, conn, dataclasses.replace(cfg, dtype="float64"),
                 "cpu")
    assert not m64.tree_kernel and solve_route(m64, cfg) == "hybrid"
    monkeypatch.setattr(tmodel, "TREE_KERNEL_MAX_BYTES", 1000)
    small = tbuild(coords, conn, cfg, "cpu")
    assert not small.tree_kernel and solve_route(small, cfg) == "hybrid"
    # a fully gripped mesh has no forest to factor
    gripped = tbuild(coords, conn,
                     dataclasses.replace(cfg, grip_length=100.0), "cpu")
    assert gripped.tree_tables is None and not gripped.tree_kernel


def test_cg_tree_route_is_the_whole_solve():
    """Below the gate solve_displacement returns what one call of K6's
    plain version returns, with B4's stop (|r| <= rtol·|free·b|, nothing
    else); the coarse weight is not read there; forcing the route off
    gives the hybrid's answer to the solver tolerance."""
    coords, conn = random_forest_mesh(260, 8, 11)
    cfg = FeaConfig(**F32)
    mt = tbuild(coords, conn, cfg, "cpu")
    act_np, anch_np = _case(mt, 0.12)
    act, anch = torch.as_tensor(act_np), torch.as_tensor(anch_np)
    x0 = torch.zeros((mt.n_nodes, 3))
    res = tsolve(mt, act, 0.01, -0.01, x0, cfg, anch)
    x, stats = tree_cg_plain(*tree_cg_inputs(mt, act, 0.01, -0.01, x0, cfg,
                                             anch))
    assert torch.equal(res.x, x.T[mt.chain.inv_perm])
    assert res.iters == int(stats[0]) >= 1
    assert res.converged and res.resnorm <= float(stats[2])
    capped = tsolve(mt, act, 0.01, -0.01, x0,
                    dataclasses.replace(cfg, max_iter=1), anch)
    assert capped.iters == 1 and not capped.converged
    weighted = tsolve(mt, act, 0.01, -0.01, x0,
                      dataclasses.replace(cfg, tree_coarse_weight=0.25), anch)
    assert torch.equal(weighted.x, res.x) and weighted.iters == res.iters
    hybrid = tsolve(dataclasses.replace(mt, tree_kernel=False), act, 0.01,
                    -0.01, x0, cfg, anch)
    assert hybrid.converged
    assert float((hybrid.x - res.x).abs().max()) \
        <= 1e-4 * float(res.x.abs().max())
    # pinned islands solve to exactly zero on both routes
    island = ~torch.as_tensor(anch_np) & mt.free_nodes
    assert island.any() and float(res.x[island].abs().max()) == 0.0


@pytest.mark.parametrize("name", ["forest260", "forest900", "synthetic2000"])
def test_kernel_tables_match_the_plan(name):
    coords, conn = {"forest260": lambda: random_forest_mesh(260, 8, 11),
                    "forest900": lambda: random_forest_mesh(900, 18, 4),
                    "synthetic2000": lambda: synthetic_mesh(2000)}[name]()
    cfg = FeaConfig(dtype="float32", operator="chain", precond="tree",
                    grip_length=grip_for(coords, 0.1))
    mt = tbuild(coords, conn, cfg, "cpu")
    plan, tk = mt.tree, mt.tree_tables
    S, P = plan.n_slots, plan.n_paths
    L = len(plan.meta.level_steps)
    assert tk.ordered and tk.lvl.shape == (4, L + 1)
    sizes = np.diff(plan.meta.level_offsets)
    assert tk.smax == sizes.max()
    assert tk.coef_floats == sum(9 * s * k for s, k in
                                 zip(sizes, plan.meta.level_steps))
    assert tk.max_steps == max(plan.meta.level_steps)
    # a path's ends know their path; every other slot has none
    fp, lp = tk.first_path.numpy(), tk.last_path.numpy()
    np.testing.assert_array_equal(fp[plan.first_gpos.numpy()], np.arange(P))
    np.testing.assert_array_equal(lp[plan.last_gpos.numpy()], np.arange(P))
    assert (fp >= 0).sum() == P and (lp >= 0).sum() == P
    # the CSR lists every real attachment once, under its junction slot,
    # in the order a sequential scatter over levels, sides, paths adds them
    tgt = plan.att_tgt.numpy().reshape(-1)
    ptr, ent = tk.att_ptr.numpy(), tk.att_ent.numpy()
    assert ptr[0] == 0 and ptr[-1] == len(ent) == (tgt < S).sum()
    assert len(set(ent.tolist())) == len(ent)
    path_level = np.repeat(np.arange(L), np.diff(plan.meta.path_offsets))
    for s in np.nonzero(np.diff(ptr))[0]:
        e = ent[ptr[s]:ptr[s + 1]]
        assert (tgt[e] == s).all()
        keys = list(zip(path_level[e >> 1], e & 1, e >> 1))
        assert keys == sorted(keys)
    lf = tk.left_fill.numpy()
    has = lf >= 0
    np.testing.assert_array_equal(has, plan.left_fill.numpy() < P)
    np.testing.assert_array_equal(lf[has] >> 1, plan.left_fill.numpy()[has])
    np.testing.assert_array_equal((lf[has] & 1).astype(bool),
                                  plan.left_fill_flip.numpy()[has])
