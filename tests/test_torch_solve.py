"""The hybrid solve end to end against the reference.

float64: the port against the reference's chain + tree path
(use_pallas=False, x64): displacement L2 < 1e-6 relative, CG iterations
within ±1. float32: against the reference's hybrid (Pallas chain matvec
in interpret mode, forced as in test_pallas_solver) to 5e-4 of the
largest displacement, at fracture fractions 0 and 0.12. Also: the model
and factor carried across from the reference give the same solve, and the
configurations the first slice refused (another operator, preconditioner
or solver, a coarse weight) now build and solve as the reference does."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mycelium_tpu.config import FeaConfig
from mycelium_tpu.fea.model import build_model as jbuild
from mycelium_tpu.fea.ramp import anchored_mask_host
from mycelium_tpu.fea.solve import compute_tree_factor as jfactor
from mycelium_tpu.fea.solve import solve_displacement as jsolve
from mycelium_tpu_torch.convert import (factor_from_jax, jax_factor_arrays,
                                        jax_model_arrays, model_from_jax)
from mycelium_tpu_torch.fea.model import build_model as tbuild
from mycelium_tpu_torch.fea.solve import compute_tree_factor as tfactor
from mycelium_tpu_torch.fea.solve import solve_displacement as tsolve
from tests.torch_support import (grip_for, jax_coarse_in_float64,
                                 random_forest_mesh, synthetic_mesh)

MESHES = {
    "forest260": lambda: random_forest_mesh(260, 8, 11),
    "forest900": lambda: random_forest_mesh(900, 18, 4),
    "synthetic2000": lambda: synthetic_mesh(2000),
}


def _case(mj, frac, seed=0):
    rng = np.random.default_rng(seed)
    act = rng.random(mj.n_elems) > frac
    grip = np.asarray(mj.top_nodes) | np.asarray(mj.bot_nodes)
    anch = anchored_mask_host(np.asarray(mj.conn), act, grip)
    return act, anch


@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("frac", [0.0, 0.12])
def test_solve_matches_reference_f64(name, frac):
    coords, conn = MESHES[name]()
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree",
                    rtol=1e-8, grip_length=grip_for(coords),
                    tree_reg_rel=1e-7)
    mj = jbuild(coords, conn, cfg)
    mt = tbuild(coords, conn, cfg, "cpu")
    act, anch = _case(mj, frac)
    x0 = np.zeros((mj.n_nodes, 3))
    rj = jsolve(mj, jnp.asarray(act), 0.01, -0.01, jnp.asarray(x0), cfg,
                jnp.asarray(anch))
    rt = tsolve(mt, torch.as_tensor(act), 0.01, -0.01, torch.as_tensor(x0),
                cfg, torch.as_tensor(anch))
    assert bool(rj.converged) and rt.converged
    xj = np.asarray(rj.x)
    assert np.linalg.norm(xj) > 0
    rel = np.linalg.norm(rt.x.numpy() - xj) / np.linalg.norm(xj)
    assert rel < 1e-6, rel
    assert abs(rt.iters - int(rj.iters)) <= 1


@pytest.mark.parametrize("frac", [0.0, 0.12])
def test_solve_matches_reference_hybrid_f32(frac):
    coords, conn = random_forest_mesh(260, 8, 11)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="tree",
                    use_pallas=True, rtol=1e-6, grip_length=0.1,
                    warm_start=False)
    mp = jbuild(coords, conn, cfg)
    mp = mp._replace(tree_packed=None, tree_packed_big=True)
    # below the whole-solve kernel's gate: force the hybrid on both sides
    mt = dataclasses.replace(tbuild(coords, conn, cfg, "cpu"),
                             tree_kernel=False)
    act, anch = _case(mp, frac)
    x0 = np.zeros((mp.n_nodes, 3), np.float32)
    rp = jsolve(mp, jnp.asarray(act), 0.01, -0.01, jnp.asarray(x0), cfg,
                jnp.asarray(anch))
    rt = tsolve(mt, torch.as_tensor(act), 0.01, -0.01, torch.as_tensor(x0),
                cfg, torch.as_tensor(anch))
    assert bool(rp.converged) and rt.converged
    assert rt.x.dtype == torch.float32
    xp = np.asarray(rp.x)
    scale = max(np.abs(xp).max(), 1e-30)
    assert np.abs(rt.x.numpy() - xp).max() / scale < 5e-4


@pytest.mark.parametrize("frac", [0.0, 0.1])
def test_model_and_factor_from_reference_give_same_solve(frac):
    coords, conn = random_forest_mesh(600, 12, 3)
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree",
                    rtol=1e-10, grip_length=0.1)
    mj = jbuild(coords, conn, cfg)
    mt = tbuild(coords, conn, cfg, "cpu")
    mc = model_from_jax(jax_model_arrays(mj), cfg, "cpu")
    act, anch = _case(mj, frac, seed=4)
    fj = jfactor(mj, jnp.asarray(act), cfg, jnp.asarray(anch))
    fc = factor_from_jax(jax_factor_arrays(fj, mj.tree.meta), mc.tree,
                         mc.dtype, "cpu")
    args = (torch.as_tensor(act), 0.01, -0.01,
            torch.zeros((mt.n_nodes, 3), dtype=torch.float64), cfg,
            torch.as_tensor(anch))
    own = tsolve(mt, *args)
    carried = tsolve(mc, *args)
    carried_fac = tsolve(mc, *args, tree_factor_val=fc)
    own_fac = tfactor(mt, torch.as_tensor(act), cfg, torch.as_tensor(anch))
    for li, a in enumerate(own_fac.alphas):
        np.testing.assert_allclose(a.numpy(), fc.alphas[li].numpy(),
                                   rtol=1e-10, atol=1e-300)
    scale = np.abs(own.x.numpy()).max()
    # the carried model is the same model: the same solve to roundoff
    assert carried.converged and carried.iters == own.iters
    assert np.abs(carried.x.numpy() - own.x.numpy()).max() <= 1e-12 * scale
    # the reference's factor differs from the port's by roundoff, which
    # steers CG differently within its tolerance (rtol 1e-10)
    assert carried_fac.converged and abs(carried_fac.iters - own.iters) <= 1
    assert np.abs(carried_fac.x.numpy() - own.x.numpy()).max() \
        <= 1e-8 * scale


@pytest.mark.parametrize("override,item", [
    (dict(operator="ell"), "operator"), (dict(precond="block_jacobi"),
                                         "precond"),
    (dict(solver="bicgstab"), "bicgstab"), (dict(solver="gmres"), "gmres"),
    (dict(tree_coarse_weight=0.25), "coarse")])
def test_configs_outside_the_slice_raise(override, item):
    """Once outside the port, each of these configurations now builds and
    solves: x within 1e-6 (relative L2) of the reference's float64 solve
    and the iterations within ±1, on a fractured forest. The reference's
    coarse operator is assembled in float64 for the comparison."""
    coords, conn = random_forest_mesh(260, 8, 11)
    cfg = dataclasses.replace(
        FeaConfig(dtype="float64", operator="chain", precond="tree",
                  grip_length=0.1, rtol=1e-8), **override)
    mj = jbuild(coords, conn, cfg)
    mt = tbuild(coords, conn, cfg, "cpu")
    act, anch = _case(mj, 0.1, seed=2)
    x0 = np.zeros((mj.n_nodes, 3))
    with jax_coarse_in_float64():
        rj = jsolve(mj, jnp.asarray(act), 0.01, -0.01, jnp.asarray(x0), cfg,
                    jnp.asarray(anch))
    rt = tsolve(mt, torch.as_tensor(act), 0.01, -0.01, torch.as_tensor(x0),
                cfg, torch.as_tensor(anch))
    assert bool(rj.converged) and rt.converged, item
    xj = np.asarray(rj.x)
    rel = np.linalg.norm(rt.x.numpy() - xj) / np.linalg.norm(xj)
    assert rel < 1e-6, (item, rel)
    assert abs(rt.iters - int(rj.iters)) <= 1, (item, rt.iters, rj.iters)
