"""The CUDA kernels on the card, each against its plain PyTorch version,
and the card-side boundary of the port: a CUDA tensor launches a kernel
or raises, never the plain path. Every test here needs a card and skips
without one. The file imports no jax, so it runs on a machine with
PyTorch for CUDA and no jax:

    python -m pytest --noconftest -p no:cacheprovider -q \
        tests/test_torch_kernels.py
"""

import numpy as np
import pytest
import torch

from mycelium_tpu.config import FeaConfig
from mycelium_tpu_torch.fea import build_model, solve_displacement
from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
from mycelium_tpu_torch.kernels import (chain_matvec, chain_matvec_plain,
                                        launch_counts, pcr_apply,
                                        pcr_apply_plain, pcr_factor,
                                        pcr_factor_plain,
                                        reset_launch_counts)
# imported by its own name (pytest puts tests/ on sys.path): a machine
# with an unrelated installed package named "tests" shadows tests.*
from torch_support import (cuda_device, grip_for,  # noqa: F401
                           level0, random_forest_mesh, rel_err,
                           synthetic_mesh)


def _chain_case(device, n_nodes=3000, frac=0.05):
    coords, conn = synthetic_mesh(n_nodes)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="tree",
                    grip_length=grip_for(coords))
    m = build_model(coords, conn, cfg, device)
    rng = np.random.default_rng(1)
    act = torch.as_tensor(rng.random(m.n_elems) > frac, device=device)
    ca_b, ja_b = plan_active_masks_bool(m.chain, act)
    u = torch.as_tensor(rng.standard_normal((3, m.n_nodes)),
                        dtype=torch.float32, device=device)
    free = m.free_nodes[m.chain.perm].float()
    return m, cfg, u, free, ca_b.float(), ja_b.float()


@pytest.mark.parametrize("bc", [True, False])
def test_chain_matvec_matches_plain(cuda_device, bc):  # noqa: F811
    m, cfg, u, free, cact, jact = _chain_case(cuda_device)
    before = launch_counts()["chain_matvec"]
    k = chain_matvec(m.chain, u, free, cact, jact, cfg.reg, bc)
    p = chain_matvec_plain(m.chain, u, free, cact, jact, cfg.reg, bc)
    torch.cuda.synchronize()
    assert launch_counts()["chain_matvec"] == before + 1
    # the same float32 terms; only the order of a node's jump sums may
    # differ (index_add_ is atomic on the card): 1e-5 of max |K·u|
    assert rel_err(k.cpu(), p.cpu()) <= 1e-5


def test_chain_matvec_rejects_bad_tensors(cuda_device):  # noqa: F811
    m, cfg, u, free, cact, jact = _chain_case(cuda_device, 1500)
    with pytest.raises(ValueError):
        chain_matvec(m.chain, u.double(), free, cact, jact, cfg.reg, True)
    strided = torch.zeros((m.n_nodes, 3), device=cuda_device).T
    with pytest.raises(ValueError):
        chain_matvec(m.chain, strided, free, cact, jact, cfg.reg, True)


def _pcr_case(device):
    return level0(12, 0.08, dtype="float32", device=device,
                  mesh=synthetic_mesh(7375))


def test_pcr_factor_matches_plain(cuda_device):  # noqa: F811
    D, B, fg, lg, steps = _pcr_case(cuda_device)
    before = launch_counts()["pcr_factor"]
    k = pcr_factor(D, B, fg, lg, steps)
    p = pcr_factor_plain(D, B, fg, lg, steps)
    torch.cuda.synchronize()
    assert launch_counts()["pcr_factor"] == before + 1
    # the same float32 operations in the same order, no FMA contraction;
    # reg-floored blocks amplify any rounding difference: 1e-4
    for a, b in zip(k, p):
        assert rel_err(a.cpu(), b.cpu()) <= 1e-4


def test_pcr_apply_matches_plain(cuda_device):  # noqa: F811
    D, B, fg, lg, steps = _pcr_case(cuda_device)
    al, be, dinv, _ = pcr_factor(D, B, fg, lg, steps)
    gen = torch.Generator(cuda_device).manual_seed(0)
    r = torch.randn((3, D.shape[1]), device=cuda_device, generator=gen)
    before = launch_counts()["pcr_apply"]
    k = pcr_apply(al, be, dinv, r)
    p = pcr_apply_plain(al, be, dinv, r)
    torch.cuda.synchronize()
    assert launch_counts()["pcr_apply"] == before + 1
    assert rel_err(k.cpu(), p.cpu()) <= 1e-5


def test_pcr_wrappers_reject_bad_tensors(cuda_device):  # noqa: F811
    D, B, fg, lg, steps = _pcr_case(cuda_device)
    with pytest.raises(ValueError):
        pcr_factor(D.double(), B.double(), fg, lg, steps)
    al, be, dinv, _ = pcr_factor(D, B, fg, lg, steps)
    strided = torch.zeros((D.shape[1], 3), device=cuda_device).T
    with pytest.raises(ValueError):
        pcr_apply(al, be, dinv, strided)
    with pytest.raises(ValueError):
        pcr_apply(al.double(), be.double(), dinv.double(),
                  strided.contiguous().double())


def test_float64_model_on_card_raises(cuda_device):  # noqa: F811
    """The card path is float32 only, as the reference's hybrid is."""
    coords, conn = random_forest_mesh(260, 8, 11)
    cfg = FeaConfig(dtype="float64", operator="chain", precond="tree",
                    grip_length=0.1)
    m = build_model(coords, conn, cfg, cuda_device)
    act = torch.ones(m.n_elems, dtype=torch.bool, device=cuda_device)
    x0 = torch.zeros((m.n_nodes, 3), dtype=torch.float64,
                     device=cuda_device)
    with pytest.raises(ValueError):
        solve_displacement(m, act, 0.01, -0.01, x0, cfg)


@pytest.mark.parametrize("dense_tail", [256, 0])
def test_solve_on_card_goes_through_the_kernels(cuda_device,  # noqa: F811
                                                dense_tail):
    """A float32 solve on the card launches all three kernels and agrees
    with the plain path on the host to 5e-4 of the largest displacement
    (float32 CG to rtol 1e-6 on both). Without the dense tail every level
    is PCR, down to one-slot levels with zero rounds."""
    coords, conn = random_forest_mesh(900, 18, 4)
    cfg = FeaConfig(dtype="float32", operator="chain", precond="tree",
                    grip_length=0.1, rtol=1e-6, tree_dense_tail=dense_tail)
    m = build_model(coords, conn, cfg, cuda_device)
    mc = build_model(coords, conn, cfg, "cpu")
    act = torch.ones(m.n_elems, dtype=torch.bool)
    x0 = torch.zeros((m.n_nodes, 3))
    reset_launch_counts()
    res = solve_displacement(m, act.to(cuda_device), 0.01, -0.01,
                             x0.to(cuda_device), cfg)
    counts = launch_counts()
    assert res.converged and all(v > 0 for v in counts.values()), counts
    if dense_tail == 0:
        assert 0 in m.tree.meta.level_steps and m.tree.meta.n_pcr == len(
            m.tree.meta.level_steps)
    ref = solve_displacement(mc, act, 0.01, -0.01, x0, cfg)
    assert np.isfinite(res.x.cpu().numpy()).all()
    assert rel_err(res.x.cpu(), ref.x) <= 5e-4
