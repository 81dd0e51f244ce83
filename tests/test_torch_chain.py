"""K1's module: the plain chain matvec against the reference's
chain.chain_apply and BC'd operator (float64, 1e-12 relative). The CUDA
kernel is held against its plain version on the card in
test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mycelium_tpu.config import FeaConfig
from mycelium_tpu.fea import chain as jchain
from mycelium_tpu.fea.model import build_model as jbuild
from mycelium_tpu_torch.fea import chain as tchain
from mycelium_tpu_torch.fea.model import build_model as tbuild
from mycelium_tpu_torch.kernels import chain_matvec
from tests.torch_support import grip_for, random_forest_mesh, synthetic_mesh


def _models(coords, conn, dtype="float64"):
    cfg = FeaConfig(dtype=dtype, operator="chain", precond="tree",
                    grip_length=grip_for(coords))
    return jbuild(coords, conn, cfg), tbuild(coords, conn, cfg, "cpu"), cfg


def _rel(a, b):
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-300)


@pytest.mark.parametrize("mesh,frac", [("forest", 0.0), ("forest", 0.1),
                                       ("synthetic", 0.05)])
def test_chain_apply_matches_reference(mesh, frac):
    coords, conn = (random_forest_mesh(600, 30, 5) if mesh == "forest"
                    else synthetic_mesh(2000))
    mj, mt, _ = _models(coords, conn)
    rng = np.random.default_rng(7)
    act = rng.random(mj.n_elems) > frac
    u = rng.standard_normal((mj.n_nodes, 3))
    ca_j, ja_j = jchain.plan_active_masks(mj.chain, jnp.asarray(act))
    ref = np.asarray(jchain.chain_apply(mj.chain, ca_j, ja_j,
                                        jnp.asarray(u)))
    ca_b, ja_b = tchain.plan_active_masks_bool(mt.chain, torch.as_tensor(act))
    np.testing.assert_array_equal(ca_b.numpy(), np.asarray(ca_j) > 0)
    out = tchain.chain_apply(mt.chain, ca_b.double(), ja_b.double(),
                             torch.as_tensor(u)).numpy()
    assert _rel(out, ref) < 1e-12


def test_bc_operator_matches_reference_formula():
    """bc=True is the reference's BC'd operator where(free, K(free·u) +
    reg·free·u, u); bc=False the raw K·u of its right-hand side."""
    coords, conn = random_forest_mesh(500, 20, 6)
    mj, mt, cfg = _models(coords, conn)
    rng = np.random.default_rng(3)
    act = rng.random(mj.n_elems) > 0.08
    free = np.asarray(mj.free_nodes) & (rng.random(mj.n_nodes) > 0.1)
    perm = np.asarray(mj.chain.perm)
    free_p = free[perm]
    u = rng.standard_normal((mj.n_nodes, 3))
    ca_j, ja_j = jchain.plan_active_masks(mj.chain, jnp.asarray(act))
    uf = np.where(free_p[:, None], u, 0.0)
    ku = np.asarray(jchain.chain_apply(mj.chain, ca_j, ja_j,
                                       jnp.asarray(uf)))
    ref_bc = np.where(free_p[:, None], ku + cfg.reg * uf, u)
    ref_raw = np.asarray(jchain.chain_apply(mj.chain, ca_j, ja_j,
                                            jnp.asarray(u)))
    ca_b, ja_b = tchain.plan_active_masks_bool(mt.chain, torch.as_tensor(act))
    args = (mt.chain, torch.as_tensor(u.T.copy()),
            torch.as_tensor(free_p).double(), ca_b.double(), ja_b.double(),
            cfg.reg)
    assert _rel(chain_matvec(*args, bc=True).numpy().T, ref_bc) < 1e-12
    assert _rel(chain_matvec(*args, bc=False).numpy().T, ref_raw) < 1e-12
