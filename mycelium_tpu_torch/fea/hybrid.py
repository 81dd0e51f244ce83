"""The hybrid solve (port of
``mycelium_tpu/fea/pallas_tree_big.py::pallas_tree_big_solve``).

One boundary-value solve: the tree-PC factorization (K2 per PCR level plus
the dense tail), a CG loop over chain-ordered (3, N) component planes, the
BC'd operator as the K1 matvec, and the tree-PC apply (K3 per level and
sweep). The reference runs this route only above its VMEM gate; the port
runs it at every mesh size. The model's dtype is kept throughout: float32
on the card (the kernels are float32-only), float64 for the CPU tests.
"""

from __future__ import annotations

import torch

from ..kernels.chain_matvec import chain_matvec
from .bc import prescribed_values
from .chain import plan_active_masks_bool
from .solve import SolveResult, compute_tree_factor, pcg
from .tree_factor import tree_apply_chain_planes


def hybrid_solve(model, active, dy_top: float, dy_bot: float, x0, cfg,
                 anchored=None, tree_factor_val=None) -> SolveResult:
    plan = model.chain
    dtype = model.dtype
    free = model.free_nodes if anchored is None \
        else model.free_nodes & anchored
    # one plan-order gather each for active and free, shared with the
    # factorization
    chain_act_b, jump_act_b = plan_active_masks_bool(plan, active)
    free_chain_b = free[plan.perm]
    cact = chain_act_b.to(dtype)
    jact = jump_act_b.to(dtype)
    freem = free_chain_b.to(dtype)
    pinm = 1.0 - freem

    uk_p = prescribed_values(model, dy_top, dy_bot)[plan.perm].T.contiguous()
    x0_p = x0.to(dtype)[plan.perm].T.contiguous()

    factor = (tree_factor_val if tree_factor_val is not None
              else compute_tree_factor(model, active, cfg, anchored,
                                       free_chain=free_chain_b,
                                       chain_act_b=chain_act_b,
                                       jump_act_b=jump_act_b))

    def matvec(u, bc):
        return chain_matvec(plan, u, freem, cact, jact, cfg.reg, bc)

    def operator(u):
        return matvec(u, True)

    S_tot = model.tree.n_slots

    def precond(r):
        if factor is None:          # no free node: identity
            return r
        up = tree_apply_chain_planes(model.tree, factor, r)
        return torch.cat([up, r[:, S_tot:]], dim=1)

    # b = pin·u_k - free·(K u_k) with the RAW K (pinned columns kept)
    b = pinm * uk_p - freem * matvec(uk_p, False)
    x_start = freem * x0_p + pinm * uk_p
    bnorm = torch.sqrt(((freem * b) ** 2).sum())
    res = pcg(operator, b, x_start, precond, cfg.rtol, cfg.atol,
              cfg.max_iter, bnorm=bnorm, n_restarts=cfg.cg_restarts)
    x = res.x.T[plan.inv_perm]
    return SolveResult(x=x, iters=res.iters, resnorm=res.resnorm,
                       converged=res.converged)
