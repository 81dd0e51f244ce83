"""Preconditioned CG and the solve dispatch (port of
``mycelium_tpu/fea/solve.py``: ``SolveResult``, ``pcg``,
``compute_tree_factor`` and ``solve_displacement``).

The port has one solve path, the hybrid (``fea/hybrid.py``): chain
operator, spanning-forest preconditioner without the cluster coarse
correction, CG. Every other configuration raises NotImplementedError
naming the ROADMAP item that ports it; none falls back to another path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch


@dataclass(frozen=True)
class SolveResult:
    x: torch.Tensor        # (N, 3) solution
    iters: int             # CG iterations (a restart counts as one)
    resnorm: float         # final |r| of the recurrence
    converged: bool


# the reference pcg's defaults, the only values its callers use
STALL_WINDOW = 256
STALL_ACCEPT = 10.0


def _dot(a, b):
    return (a * b).sum()


def pcg(operator: Callable, b, x0, precond: Callable, rtol: float,
        atol: float, max_iter: int, bnorm=None,
        n_restarts: int = 0) -> SolveResult:
    """Preconditioned conjugate gradients on the SPD BC'd operator, with
    the reference's stall exit and true-residual restarts.

    ``bnorm`` scales rtol by the condensed right-hand side (free rows).
    If the best residual has not improved by 0.1% in STALL_WINDOW
    iterations the loop exits; a plateau already within STALL_ACCEPT·tol
    exits after STALL_WINDOW/8 and still counts as converged.
    ``n_restarts``: on a plateau, first rebuild the Krylov space from the
    true residual b - K·x (one operator apply, counted as an iteration),
    up to this many times; restarted segments use the short window.

    The loop reads |r| on the host once per iteration for its stop test;
    everything else stays on the device."""
    if bnorm is None:
        bnorm = torch.sqrt(_dot(b, b))
    tol = max(rtol * float(bnorm), atol)
    near_window = max(STALL_WINDOW // 8, 8)

    x = x0
    r = b - operator(x0)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    rn = torch.sqrt(_dot(r, r))
    rnorm = float(rn)
    k, best, since, rleft = 0, rnorm, 0, n_restarts
    while True:
        near = rnorm <= STALL_ACCEPT * tol
        used = rleft < n_restarts
        win = near_window if (near or used) else STALL_WINDOW
        stalled = since >= win and rleft == 0
        if not (k < max_iter and rnorm > tol and not stalled):
            break
        if n_restarts and since >= near_window and rleft > 0:
            r = b - operator(x)
            z = precond(r)
            p = z
            rz = _dot(r, z)
            rnorm = float(torch.sqrt(_dot(r, r)))
            k += 1
            best = min(best, rnorm)
            since = 0
            rleft -= 1
            continue
        ap = operator(p)
        pap = _dot(p, ap)
        alpha = torch.where(pap > 0, rz / torch.where(pap > 0, pap, 1.0),
                            0.0)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond(r)
        rz_new = _dot(r, z)
        beta = torch.where(rz > 0, rz_new / torch.where(rz > 0, rz, 1.0),
                           0.0)
        p = z + beta * p
        rz = rz_new
        rnorm = float(torch.sqrt(_dot(r, r)))
        k += 1
        improved = rnorm < best * (1.0 - 1e-3)
        best = min(best, rnorm)
        since = 0 if improved else since + 1
    stalled = since >= near_window
    converged = rnorm <= tol or (stalled and rnorm <= STALL_ACCEPT * tol)
    return SolveResult(x=x, iters=k, resnorm=rnorm, converged=converged)


def _free_mask(model, anchored):
    return model.free_nodes if anchored is None \
        else model.free_nodes & anchored


def compute_tree_factor(model, active, cfg, anchored=None, free_chain=None,
                        chain_act_b=None, jump_act_b=None):
    """The per-solve tree-PC factorization, exposed so the ramp can
    reuse it across steps whose active mask did not change. None when no
    node is free (the preconditioner is then the identity)."""
    from .tree_factor import tree_factor_fast
    if model.tree_fast is None:
        return None
    free = _free_mask(model, anchored)
    free_p = free[model.chain.perm] if free_chain is None else free_chain
    reg_pc = max(cfg.reg, cfg.tree_reg_rel * model.tree.meta.k_scale)
    return tree_factor_fast(model.tree, model.tree_fast, model.chain,
                            active, free, free_p, reg_pc, model.conn,
                            chain_act_b=chain_act_b, jump_act_b=jump_act_b)


def check_supported(cfg) -> None:
    """Raise NotImplementedError for a configuration outside the slice."""
    if cfg.operator != "chain":
        raise NotImplementedError(
            f"operator={cfg.operator!r}: only 'chain' is ported; the ELL "
            "and scatter operators come with the solver sweep (ROADMAP "
            "queue A item 10)")
    if cfg.precond != "tree":
        raise NotImplementedError(
            f"precond={cfg.precond!r}: only 'tree' is ported; block-Jacobi, "
            "Jacobi, coarse and none come with the solver sweep (ROADMAP "
            "queue A item 10, queue B item 6)")
    if cfg.solver != "cg":
        raise NotImplementedError(
            f"solver={cfg.solver!r}: bicgstab and gmres are not ported yet "
            "(ROADMAP queue A, 'bicgstab and gmres')")
    if cfg.tree_coarse_weight > 0.0:
        raise NotImplementedError(
            f"tree_coarse_weight={cfg.tree_coarse_weight}: the cluster "
            "coarse correction is not ported yet (ROADMAP queue A, "
            "'coarse correction'); use tree_coarse_weight=0")


def solve_displacement(model, active, dy_top: float, dy_bot: float, x0,
                       cfg, anchored=None,
                       tree_factor_val=None) -> SolveResult:
    """One boundary-value solve of the ramp: K_ff u_f = −K_fk u_k.

    ``anchored`` marks nodes still connected to a grip through active
    elements; the others are pinned to zero (the direct solver's answer).
    ``tree_factor_val`` is a precomputed compute_tree_factor result for the
    same (active, anchored)."""
    check_supported(cfg)
    from .hybrid import hybrid_solve
    return hybrid_solve(model, active, dy_top, dy_bot, x0, cfg, anchored,
                        tree_factor_val=tree_factor_val)
