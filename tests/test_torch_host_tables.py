"""The port's host-side plan construction against the reference's:
incidence, unified order, chain plan, tree schedule, tree plan and the
fast-factor tables must be array-equal on the test scenes and on
synthetic meshes."""

import numpy as np
import pytest

from mycelium_tpu.config import FeaConfig
from mycelium_tpu.fea import chain as jchain
from mycelium_tpu.fea import model as jmodel
from mycelium_tpu.fea import tree as jtree
from mycelium_tpu_torch.fea import chain as tchain
from mycelium_tpu_torch.fea import model as tmodel
from mycelium_tpu_torch.fea import tree as ttree
from tests.torch_support import (grip_for, np_of, random_forest_mesh, scene,
                                 synthetic_mesh)

MESHES = {
    "test_I": lambda: scene("test_I"),
    "test_t": lambda: scene("test_t"),
    "test_y": lambda: scene("test_y"),
    "test_X": lambda: scene("test_X"),
    "forest260": lambda: random_forest_mesh(260, 8, 11),
    "forest900": lambda: random_forest_mesh(900, 18, 4),
    "synthetic2000": lambda: synthetic_mesh(2000),
}


def _cfg(coords):
    return FeaConfig(dtype="float64", operator="chain", precond="tree",
                     grip_length=grip_for(coords))


@pytest.mark.parametrize("name", list(MESHES))
def test_host_tables_array_equal(name):
    coords, conn = MESHES[name]()
    cfg = _cfg(coords)
    conn = np.asarray(conn, np.int32)
    n = coords.shape[0]
    y = coords[:, 1]
    top = np.abs(y - y.max()) < cfg.grip_length
    bot = np.abs(y - y.min()) < cfg.grip_length
    free = ~((top & ~bot) | bot)

    for a, b in zip(tmodel._build_incidence(conn, n),
                    jmodel._build_incidence(conn, n)):
        np.testing.assert_array_equal(a, b)

    sj = jtree.build_tree_schedule(conn, n, free, max_path_len=128)
    st = ttree.build_tree_schedule(conn, n, free, max_path_len=128)
    assert st.n_fill == sj.n_fill and len(st.levels) == len(sj.levels)
    np.testing.assert_array_equal(st.tree_edge, sj.tree_edge)
    for lt, lj in zip(st.levels, sj.levels):
        for f in lj._fields:
            np.testing.assert_array_equal(getattr(lt, f), getattr(lj, f),
                                          err_msg=f)

    perm = tmodel._unified_order(st, n)
    np.testing.assert_array_equal(perm, jmodel._unified_order(sj, n))

    d = coords[conn[:, 1]] - coords[conn[:, 0]]
    ln = np.maximum(np.linalg.norm(d, axis=1), 1e-12)
    geom_n = d / ln[:, None]
    k_ax = cfg.e_mod * cfg.area / ln
    k_bd = 12.0 * cfg.e_mod * cfg.moi / ln ** 3
    host_j = {}
    jchain.build_chain_plan(coords, conn, geom_n, k_ax, k_bd, np.float64,
                            host_out=host_j, perm=perm)
    host_t = tchain.build_chain_plan(coords, conn, geom_n, k_ax, k_bd,
                                     perm=perm)
    for k in ("perm", "inv_perm", "chain_elem", "chain_n", "chain_kax",
              "chain_kbd", "jump_elem", "jump_n", "jump_kax", "jump_kbd",
              "ja", "jb"):
        np.testing.assert_array_equal(host_t[k], host_j[k], err_msg=k)
    np.testing.assert_array_equal(ttree.element_k3(geom_n, k_ax, k_bd),
                                  jtree.element_k3(geom_n, k_ax, k_bd))


@pytest.mark.parametrize("name", list(MESHES))
def test_model_tables_array_equal(name):
    """build_model end to end: every static table of the port's model
    (tree plan, fast-factor tables, chain plan) equals the reference's."""
    coords, conn = MESHES[name]()
    cfg = _cfg(coords)
    mj = jmodel.build_model(coords, conn, cfg)
    mt = tmodel.build_model(coords, conn, cfg, "cpu")
    for k in ("incident", "sign", "top_nodes", "bot_nodes", "free_nodes",
              "coords", "conn"):
        np.testing.assert_array_equal(np_of(getattr(mt, k)),
                                      np.asarray(getattr(mj, k)), err_msg=k)
    for k in ("perm", "inv_perm", "chain_elem", "chain_kax", "chain_kbd",
              "jump_elem", "jump_kax", "jump_kbd", "ja", "jb"):
        np.testing.assert_array_equal(np_of(getattr(mt.chain, k)),
                                      np.asarray(getattr(mj.chain, k)),
                                      err_msg=k)
    for k in ("chain_n", "jump_n"):
        np.testing.assert_array_equal(np_of(getattr(mt.chain, k)).T,
                                      np.asarray(getattr(mj.chain, k)))
    assert mt.tree.meta.level_offsets == mj.tree.meta.level_offsets
    assert mt.tree.meta.path_offsets == mj.tree.meta.path_offsets
    assert mt.tree.meta.level_steps == mj.tree.meta.level_steps
    assert mt.tree.meta.n_pcr == mj.tree.meta.n_pcr
    assert mt.tree.meta.k_scale == mj.tree.meta.k_scale
    for k in ("tree_edge", "k3", "slots", "left_elem", "left_fill",
              "left_fill_flip", "first_gpos", "last_gpos", "att_elem",
              "att_fill", "att_flip", "att_tgt", "has_fill", "dense_eid",
              "dense_i", "dense_j"):
        np.testing.assert_array_equal(np_of(getattr(mt.tree, k)),
                                      np.asarray(getattr(mj.tree, k)),
                                      err_msg=k)
    assert (mt.tree_fast is None) == (mj.tree_fast is None)
    if mj.tree_fast is not None:
        for k in ("chain_tree", "jump_tree", "left_k3", "ja", "jb"):
            np.testing.assert_array_equal(
                np_of(getattr(mt.tree_fast, k)),
                np.asarray(getattr(mj.tree_fast, k)), err_msg=k)
        assert mt.tree_fast.meta.level_left_fill == \
            mj.tree_fast.meta.level_left_fill
        assert mt.tree_fast.meta.left_is_chain_shift == \
            mj.tree_fast.meta.left_is_chain_shift


def test_jump_csr_lists_every_jump_end_once():
    """The kernel's per-node jump CSR holds each real jump at both ends
    (2j at ja[j], 2j+1 at jb[j]) and nothing else."""
    coords, conn = random_forest_mesh(600, 40, 2)
    cfg = _cfg(coords)
    m = tmodel.build_model(coords, conn, cfg, "cpu")
    ptr, ent = np_of(m.chain.jump_ptr), np_of(m.chain.jump_ent)
    ja, jb = np_of(m.chain.ja), np_of(m.chain.jb)
    n_jumps = int((np_of(m.chain.jump_elem) < m.n_elems).sum())
    assert n_jumps > 0 and len(ent) == 2 * n_jumps
    assert sorted(ent.tolist()) == list(range(2 * n_jumps))
    for p in range(m.n_nodes):
        for e in ent[ptr[p]:ptr[p + 1]]:
            assert (ja if e % 2 == 0 else jb)[e // 2] == p


def test_support_mesh_is_the_tree_pc_mesh():
    """tests/torch_support.py keeps a jax-free copy of the tree-PC tests'
    mesh generator; it must give the same arrays."""
    from tests.test_tree_pc import random_forest_mesh as reference
    for args in ((260, 8, 11), (900, 18, 4)):
        for a, b in zip(random_forest_mesh(*args), reference(*args)):
            np.testing.assert_array_equal(a, b)
