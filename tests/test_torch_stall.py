"""The stall exit of K6 (mycelium_tpu_torch/kernels/tree_cg.py, the cg +
tree route of solve_displacement on a float32 model) against the JAX
package's ``pcg``, which runs such solves above the reference's memory
gate for its whole-solve tree kernel.

A 5% fractured random forest in float32 does not reach rtol 1e-6 with
every forest level on PCR (K6's preconditioner, and B4's): |r| stops
falling near 1e5·tol after a few iterations. Without a stall exit K6 ran
such a solve to max_iter. The JAX side runs ``pcg`` in XLA
(``use_pallas=False``) with the same preconditioner (every level on PCR:
``tree_dense_tail=0``) and no true-residual restarts (K6 has none), so
both sides stop on the same rule: far from the tolerance after 256 flat
iterations, not converged; with a looser rtol, on the plateau within
STALL_ACCEPT·tol after 32, converged. Iterations and verdicts equal, |r|
within 1e-3 (float32, sums in another order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mycelium_tpu.config import FeaConfig as JaxConfig
from mycelium_tpu.fea.model import build_model as jbuild
from mycelium_tpu.fea.solve import solve_displacement as jsolve
from mycelium_tpu_torch.config import FeaConfig
from mycelium_tpu_torch.fea.model import build_model as tbuild
from mycelium_tpu_torch.fea.ramp import anchored_mask_host
from mycelium_tpu_torch.fea.solve import solve_displacement, solve_route
from mycelium_tpu_torch.kernels.tree_cg import (NEAR_WINDOW, STALL_WINDOW,
                                                stall_converged)
from tests.torch_support import grip_for, random_forest_mesh

MAX_ITER = 2000


@pytest.fixture(scope="module")
def forest():
    return random_forest_mesh(260, 8, 11)


def _kw(coords, rtol):
    return dict(dtype="float32", operator="chain", precond="tree",
                grip_length=grip_for(coords), rtol=rtol, tree_reg_rel=1e-7,
                max_iter=MAX_ITER, warm_start=False, cg_restarts=0,
                tree_dense_tail=0)


@pytest.mark.parametrize("rtol,converged", [(1e-6, False), (0.03, True)])
def test_k6_stops_where_pcg_stops(forest, rtol, converged):
    coords, conn = forest
    mt = tbuild(coords, conn, FeaConfig(**_kw(coords, rtol)), "cpu")
    cfg = FeaConfig(**_kw(coords, rtol))
    assert mt.tree_kernel and solve_route(mt, cfg) == "tree_cg"
    rng = np.random.default_rng(0)
    act = rng.random(mt.n_elems) >= 0.05
    grip = (mt.top_nodes | mt.bot_nodes).numpy()
    anch = anchored_mask_host(np.asarray(conn), act, grip)
    rt = solve_displacement(mt, torch.as_tensor(act), 0.02, -0.02,
                            torch.zeros((mt.n_nodes, 3)), cfg,
                            torch.as_tensor(anch))
    jcfg = JaxConfig(**_kw(coords, rtol))
    mj = jbuild(coords, conn, jcfg)
    rj = jsolve(mj, jnp.asarray(act), 0.02, -0.02,
                jnp.zeros((mj.n_nodes, 3), jnp.float32), jcfg,
                jnp.asarray(anch))
    # a plateau: the exit comes one window after the last improvement
    window = NEAR_WINDOW if converged else STALL_WINDOW
    assert window < rt.iters < window + 20
    assert rt.iters == int(rj.iters)
    assert rt.converged == bool(rj.converged) == converged
    assert abs(rt.resnorm - float(rj.resnorm)) <= 1e-3 * float(rj.resnorm)


def test_stall_verdict_is_pcgs():
    """On the tolerance whatever the count; on a plateau only within
    STALL_ACCEPT·tol and after NEAR_WINDOW flat iterations."""
    assert stall_converged(1.0, 1.0, 0)
    assert not stall_converged(9.0, 1.0, NEAR_WINDOW - 1)
    assert stall_converged(9.0, 1.0, NEAR_WINDOW)
    assert not stall_converged(11.0, 1.0, STALL_WINDOW)
