"""Shared pieces of the PyTorch-port tests (tests/test_torch_*.py): the
test meshes, the PCR level inputs, and the fixture that hands a CUDA
device to the tests that need the card. Imports no jax, so the card's
tests (test_torch_kernels.py) run where jax is not installed."""

import numpy as np
import pytest
import torch

from mycelium_tpu import scenes


def random_forest_mesh(n_nodes=600, n_extra=12, seed=0):
    """The mesh of tests/test_tree_pc.py::random_forest_mesh (same seeds,
    same arrays): chains that branch, plus a few cycle-closing edges."""
    rng = np.random.default_rng(seed)
    coords = [np.zeros(3)]
    conn = []
    while len(coords) < n_nodes:
        start = int(rng.integers(0, len(coords)))
        phi = rng.uniform(0, 2 * np.pi)
        pos = coords[start].copy()
        prev = start
        for _ in range(int(rng.integers(2, 14))):
            if len(coords) >= n_nodes:
                break
            phi += rng.uniform(-0.4, 0.4)
            pos = pos + np.array([np.cos(phi), np.sin(phi), 0.0]) * 0.05
            coords.append(pos)
            conn.append([prev, len(coords) - 1])
            prev = len(coords) - 1
    for _ in range(n_extra):
        a, b = rng.integers(0, n_nodes, 2)
        if a != b:
            conn.append([a, b])
    return np.asarray(coords), np.asarray(conn, np.int32)


def synthetic_mesh(n_nodes):
    import bench
    return bench.synthetic_mesh(n_nodes)


def scene(name):
    sc = scenes.SCENES[name]()
    return sc.coords, sc.conn


def grip_for(coords, frac=0.15):
    """A grip length that leaves the middle of the mesh free."""
    y = coords[:, 1]
    return frac * float(y.max() - y.min())


def np_of(t):
    return t.detach().cpu().numpy()


def rel_err(a, b):
    """max |a - b| / max |b|."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if b.size == 0:
        return 0.0
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


def level0(seed, frac, dtype="float64", device="cpu", mesh=None):
    """(D, B, fg, lg, steps) of the largest PCR level as the
    factorization builds it, under a partly fractured mask with the
    islands it cuts off pinned (as the ramp pins them)."""
    from mycelium_tpu.config import FeaConfig
    from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
    from mycelium_tpu_torch.fea.model import build_model
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    from mycelium_tpu_torch.fea.tree_factor import (chain_tree_diag,
                                                    left_couplings)
    coords, conn = mesh if mesh is not None else \
        random_forest_mesh(900, 18, seed)
    cfg = FeaConfig(dtype=dtype, operator="chain", precond="tree",
                    grip_length=grip_for(coords, 0.08))
    m = build_model(coords, conn, cfg, device)
    rng = np.random.default_rng(seed)
    act_np = rng.random(m.n_elems) > frac
    grip = (m.top_nodes | m.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), act_np,
                                              grip), device=device)
    act = torch.as_tensor(act_np, device=device)
    free_chain = (m.free_nodes & anch)[m.chain.perm]
    cab, jab = plan_active_masks_bool(m.chain, act)
    meta = m.tree.meta
    S = meta.level_offsets[1]
    reg_pc = max(cfg.reg, cfg.tree_reg_rel * meta.k_scale)
    D = chain_tree_diag(m.tree, m.tree_fast, m.chain, act, free_chain,
                        reg_pc, cab, jab)[:, :S].contiguous()
    B = left_couplings(m.tree, m.tree_fast, act, free_chain, m.n_elems,
                       cab)[:, :S].contiguous()
    p1 = meta.path_offsets[1]
    return D, B, m.tree.first_gpos[:p1], m.tree.last_gpos[:p1], \
        meta.level_steps[0]


@pytest.fixture
def cuda_device():
    """torch.device('cuda'), or a skip when this machine has no card
    (decided when the test runs, not when the module is imported)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")
