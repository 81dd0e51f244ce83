"""The cg + tree chain solve through the whole-solve kernel K6 (port of
``mycelium_tpu/fea/pallas_tree.py::pallas_tree_solve``).

Builds the kernel's inputs in chain order: the prescribed values and the
start vector as (3, N) planes, the free and active masks, and the
per-solve numerics of the forest factorization (its diagonal with
reg_pc = max(reg, tree_reg_rel·k_scale), the left-edge and the attachment
element couplings, masked by active, forest membership and both ends free),
then runs factorization, preconditioner and PCG in one launch (the plain
version on the CPU) and reads its [iterations, |r|, tol] once. B4's
semantics: every level on PCR, no dense tail, no coarse stage (the
configuration's ``tree_coarse_weight`` is not read), stop on
r·r <= rtol²·|free·b|², no atol, no stall exit, no restarts.
"""

from __future__ import annotations

from ..kernels.tree_cg import tree_cg
from .bc import prescribed_values
from .chain import plan_active_masks_bool
from .solve import SolveResult, free_mask
from .tree_factor import tree_factor_inputs


def tree_cg_inputs(model, active, dy_top: float, dy_bot: float, x0, cfg,
                   anchored=None) -> tuple:
    """The arguments of ``kernels.tree_cg`` for one solve."""
    plan = model.chain
    dtype = model.dtype
    free = free_mask(model, anchored)
    chain_act_b, jump_act_b = plan_active_masks_bool(plan, active)
    free_chain_b = free[plan.perm]
    uk_p = prescribed_values(model, dy_top, dy_bot)[plan.perm].T.contiguous()
    x0_p = x0.to(dtype)[plan.perm].T.contiguous()
    reg_pc = max(cfg.reg, cfg.tree_reg_rel * model.tree.meta.k_scale)
    d9, bel, katt = tree_factor_inputs(
        model.tree, model.tree_fast, plan, active, free, free_chain_b,
        reg_pc, model.conn, chain_act_b, jump_act_b)
    return (plan, model.tree, model.tree_tables, uk_p, x0_p,
            free_chain_b.to(dtype), chain_act_b.to(dtype),
            jump_act_b.to(dtype), d9.contiguous(), bel.contiguous(), katt,
            cfg.rtol, cfg.reg, cfg.max_iter)


def tree_cg_solve(model, active, dy_top: float, dy_bot: float, x0, cfg,
                  anchored=None) -> SolveResult:
    x_p, stats = tree_cg(*tree_cg_inputs(model, active, dy_top, dy_bot, x0,
                                         cfg, anchored))
    iters, rnorm, tol = stats.tolist()
    return SolveResult(x=x_p.T[model.chain.inv_perm], iters=int(iters),
                       resnorm=rnorm, converged=rnorm <= tol)
