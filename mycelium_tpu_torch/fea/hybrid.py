"""The chain path: every solve with operator='chain' but cg + coarse (port
of ``mycelium_tpu/fea/pallas_tree_big.py::pallas_tree_big_solve``, the
reference's hybrid, for cg + tree, and of the eager chain path of
``mycelium_tpu/fea/solve.py:581-652`` for the other combinations).

One boundary-value solve on chain-ordered (3, N) component planes: the BC'd
operator is the K1 matvec, the preconditioner one of

- tree: the forest factorization (K2 per PCR level plus the dense tail)
  and its apply (K3 per level and sweep), plus tree_coarse_weight times
  the cluster coarse correction when the weight is > 0;
- coarse: the 3x3 block inverse plus the coarse correction (for the
  solvers other than cg; cg + coarse runs the whole-solve kernel K5);
- block_jacobi, jacobi (point-Jacobi), none;

and the solver is cfg.solver. cg + tree comes here only on a model that
cannot run the whole-solve kernel K6 (``model.tree_kernel`` false: float64,
or past the kernel's memory guard). The model's dtype is kept throughout:
float32 on the card (the kernels are float32-only), float64 for the CPU
tests.
"""

from __future__ import annotations

import torch

from ..kernels.chain_matvec import ChainOperator
from .bc import prescribed_values
from .chain import plan_active_masks_bool
from .solve import (SOLVERS, SolveResult, chain_preconditioner, free_mask,
                    solver_kwargs)


def chain_path_solve(model, active, dy_top: float, dy_bot: float, x0, cfg,
                     anchored=None, tree_factor_val=None) -> SolveResult:
    plan = model.chain
    dtype = model.dtype
    free = free_mask(model, anchored)
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
    precond = chain_preconditioner(model, active, cfg, free, tree_factor_val,
                                   free_chain_b, chain_act_b, jump_act_b)

    # K1 bound once a solve: the plan and the masks are validated here, a
    # call passes the vector
    op = ChainOperator(plan, freem, cact, jact, cfg.reg)

    def operator(u):
        return op.apply(u, True)

    # b = pin·u_k - free·(K u_k) with the RAW K (pinned columns kept)
    b = pinm * uk_p - freem * op.apply(uk_p, False)
    x_start = freem * x0_p + pinm * uk_p
    bnorm = torch.sqrt(((freem * b) ** 2).sum())
    res = SOLVERS[cfg.solver](operator, b, x_start, precond, cfg.rtol,
                              cfg.atol, cfg.max_iter, bnorm=bnorm,
                              **solver_kwargs(cfg))
    x = res.x.T[plan.inv_perm]
    return SolveResult(x=x, iters=res.iters, resnorm=res.resnorm,
                       converged=res.converged)
