"""The tree preconditioner: the port's tree_factor_fast and
tree_apply_chain_planes against tree_jax's in float64 (1e-10), with and
without fracture and extra pins, across dense-tail splits."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mycelium_tpu.config import FeaConfig
from mycelium_tpu.fea import tree_jax as trj
from mycelium_tpu.fea.model import build_model as jbuild
from mycelium_tpu_torch.fea.model import build_model as tbuild
from mycelium_tpu_torch.fea.tree_factor import (tree_apply_chain_planes,
                                                tree_factor_fast)
from tests.torch_support import grip_for, random_forest_mesh, synthetic_mesh


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if b.size == 0:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("mesh,frac,pin,tail", [
    ("forest", 0.0, 0.0, 256), ("forest", 0.1, 0.05, 256),
    ("forest", 0.1, 0.0, 0), ("forest", 0.05, 0.0, 32),
    ("synthetic", 0.05, 0.02, 256)])
def test_factor_and_apply_match_reference(mesh, frac, pin, tail):
    coords, conn = (random_forest_mesh(900, 18, 5) if mesh == "forest"
                    else synthetic_mesh(2000))
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree",
                    grip_length=grip_for(coords, 0.08), tree_dense_tail=tail)
    mj = jbuild(coords, conn, cfg)
    mt = tbuild(coords, conn, cfg, "cpu")
    rng = np.random.default_rng(17)
    act = rng.random(mj.n_elems) > frac
    free = np.asarray(mj.free_nodes) & (rng.random(mj.n_nodes) > pin)
    perm = np.asarray(mj.chain.perm)
    reg = 1e-7 * mj.tree.meta.k_scale

    fj = trj.tree_factor_fast(mj.tree, mj.tree_fast, mj.chain,
                              jnp.asarray(act), jnp.asarray(free),
                              jnp.asarray(free[perm]), jnp.asarray(reg),
                              mj.conn)
    ft = tree_factor_fast(mt.tree, mt.tree_fast, mt.chain,
                          torch.as_tensor(act), torch.as_tensor(free),
                          torch.as_tensor(free[perm]), reg, mt.conn)
    assert len(ft.alphas) == len(fj.alphas)
    for li in range(len(ft.alphas)):
        assert _rel(ft.alphas[li].numpy(), fj.alphas[li]) < 1e-10
        assert _rel(ft.betas[li].numpy(), fj.betas[li]) < 1e-10
    dinv = (torch.cat(ft.dinvs, dim=1).numpy() if ft.dinvs
            else np.zeros((9, 0)))
    assert _rel(dinv, fj.dinv) < 1e-10
    assert _rel(ft.att_b.numpy(), fj.att_b) < 1e-10
    assert (ft.sinv is None) == (fj.sinv is None)
    if fj.sinv is not None:
        assert _rel(ft.sinv.numpy(), fj.sinv) < 1e-10

    r = rng.standard_normal((3, mj.n_nodes))
    zj = np.stack(trj.tree_apply_chain_planes(
        mj.tree, fj, tuple(jnp.asarray(p) for p in r)))
    zt = tree_apply_chain_planes(mt.tree, ft, torch.as_tensor(r)).numpy()
    assert zt.shape == zj.shape
    assert _rel(zt, zj) < 1e-10


def test_apply_inverts_the_tree_operator():
    """The apply solves the factored system: feeding it the tree operator
    applied to a vector returns that vector (intact forest, float64)."""
    from mycelium_tpu.fea.tree import tree_apply_np, tree_factor_np
    from mycelium_tpu_torch.fea.tree import build_tree_schedule, element_k3
    coords, conn = random_forest_mesh(600, 0, 8)   # a forest: no cycles
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree",
                    grip_length=grip_for(coords, 0.08))
    mt = tbuild(coords, conn, cfg, "cpu")
    free = mt.free_nodes.numpy()
    perm = mt.chain.perm.numpy()
    reg = 1e-7 * mt.tree.meta.k_scale
    act = np.ones(mt.n_elems, bool)
    ft = tree_factor_fast(mt.tree, mt.tree_fast, mt.chain,
                          torch.as_tensor(act), mt.free_nodes,
                          mt.free_nodes[mt.chain.perm], reg, mt.conn)
    # numpy oracle of the same factorization (reference tree.py)
    sch = build_tree_schedule(np.asarray(conn), mt.n_nodes, free,
                              max_path_len=cfg.tree_max_path_len)
    k3 = element_k3(mt.geom.n.numpy(), mt.geom.k_ax.numpy(),
                    mt.geom.k_bd.numpy())
    fac_np = tree_factor_np(sch, k3, act, free, reg)
    rng = np.random.default_rng(0)
    r = rng.standard_normal((mt.n_nodes, 3))
    r[~free] = 0.0
    z_np = tree_apply_np(fac_np, r)
    zt = tree_apply_chain_planes(mt.tree, ft,
                                 torch.as_tensor(r[perm].T.copy()))
    S = mt.tree.n_slots
    assert _rel(zt.numpy().T, z_np[perm][:S]) < 1e-8


def test_fully_gripped_mesh_has_no_factor():
    """A scene with every node gripped has nothing to eliminate."""
    from mycelium_tpu import scenes
    from mycelium_tpu_torch.fea.solve import compute_tree_factor
    sc = scenes.SCENES["test_I"]()
    cfg = dataclasses.replace(
        FeaConfig(dtype="float64", operator="chain", precond="tree"),
        grip_length=5.0)
    mt = tbuild(sc.coords, sc.conn, cfg, "cpu")
    assert mt.tree.n_slots == 0 and mt.tree_fast is None
    act = torch.ones(mt.n_elems, dtype=torch.bool)
    assert compute_tree_factor(mt, act, cfg) is None
