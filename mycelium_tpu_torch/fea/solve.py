"""Krylov solvers, preconditioners and the solve dispatch (port of
``mycelium_tpu/fea/solve.py``: ``SolveResult``, ``make_preconditioner``,
``_coarse_preconditioner``, ``pcg``, ``bicgstab``, ``gmres``, ``SOLVERS``,
``compute_tree_factor`` and ``solve_displacement``).

Each solver is a Python loop that reads one scalar on the host per
iteration (per Arnoldi step for GMRES) for its stop test; everything else
stays on the device. The routes of ``solve_displacement``:

- operator 'chain', cg + coarse: the whole-solve kernel K5
  (``fea/chain_solve.py``), one launch per solve;
- operator 'chain', cg + tree on a model that can run it
  (``model.tree_kernel``: float32, within the kernel's memory guard): the
  whole-solve tree kernel K6 (``fea/tree_solve.py``), one launch per
  solve, no coarse stage;
- operator 'chain', any other combination: the chain path
  (``fea/hybrid.py``), with K1 as its operator on the card; cg + tree on
  a model that cannot run K6 is the reference's hybrid;
- operator 'ell' or 'scatter': the node-space path below.

Unlike the reference (``solve.py:574-579``, fault C7 in ROADMAP), no
preconditioner other than 'coarse' is sent to the whole-solve kernel,
whose preconditioner is always block-Jacobi plus the coarse correction.
``precond='jacobi'`` is point-Jacobi on every route (the reference's chain
path runs block-Jacobi for it, fault C1).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Callable

import numpy as np
import torch

from ..utils import profiling
from .blocks import block_planes, mv3_planes
from .coarse import cluster_layout, coarse_inverse, coarse_space
from .model import diag_blocks, invert_blocks

SOLVER_NAMES = ("cg", "bicgstab", "gmres")
PRECOND_NAMES = ("tree", "coarse", "block_jacobi", "jacobi", "none")
OPERATOR_NAMES = ("chain", "ell", "scatter")


@dataclass(frozen=True)
class SolveResult:
    # x: on the routes 'tree_cg' and 'chain_cg' on the card a buffer of the
    # model's launch, valid through the next solve on that model and
    # overwritten by the one after (kernels.TreeCgLaunch, ChainCgLaunch); a
    # caller that keeps it longer copies it
    x: torch.Tensor        # (N, 3) solution
    iters: int             # iterations (Arnoldi steps for gmres)
    resnorm: float         # final |r|
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
    up to this many times; restarted segments use the short window."""
    if bnorm is None:
        bnorm = torch.sqrt(_dot(b, b))
    tol = max(rtol * float(bnorm), atol)
    near_window = max(STALL_WINDOW // 8, 8)

    x = x0
    r = b - operator(x0)
    z = precond(r)
    p = z
    rz = _dot(r, z)
    rnorm = float(torch.sqrt(_dot(r, r)))
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


def bicgstab(operator: Callable, b, x0, precond: Callable, rtol: float,
             atol: float, max_iter: int, bnorm=None) -> SolveResult:
    """Right-preconditioned BiCGStab (the 'bcgs' leg of the reference's
    sweep). The stabilization step is skipped when the half-iterate is
    already converged or omega is not finite."""
    if bnorm is None:
        bnorm = torch.sqrt(_dot(b, b))
    tol = max(rtol * float(bnorm), atol)
    eps = 1e-300 if b.dtype == torch.float64 else 1e-30

    def guard(v):
        return torch.where(v.abs() > eps, v, eps)

    x = x0
    r = b - operator(x0)
    rhat = r
    p = r
    v = torch.zeros_like(b)
    rho = alpha = omega = torch.ones((), dtype=b.dtype, device=b.device)
    rnorm = float(torch.sqrt(_dot(r, r)))
    k = 0
    while k < max_iter and rnorm > tol and math.isfinite(rnorm):
        rho_new = _dot(rhat, r)
        beta = (rho_new / guard(rho)) * (alpha / guard(omega))
        p = r + beta * (p - omega * v)
        phat = precond(p)
        v = operator(phat)
        alpha = rho_new / guard(_dot(rhat, v))
        s = r - alpha * v
        shat = precond(s)
        t = operator(shat)
        tt = _dot(t, t)
        s_small = torch.sqrt(_dot(s, s)) <= tol
        omega_raw = _dot(t, s) / torch.where(tt > eps, tt, eps)
        omega = torch.where(torch.isfinite(omega_raw) & ~s_small,
                            omega_raw, 0.0)
        x = x + alpha * phat + omega * shat
        r = s - omega * t
        rho = rho_new
        rnorm = float(torch.sqrt(_dot(r, r)))
        k += 1
    return SolveResult(x=x, iters=k, resnorm=rnorm, converged=rnorm <= tol)


def _back_substitute(R, g, j, dt):
    """y = R[:j, :j]^-1 g[:j] in the host dtype ``dt``; a zero diagonal
    entry reads as 1 (the reference's masked triangular solve)."""
    y = np.zeros(j, dt)
    for i in range(j - 1, -1, -1):
        acc = g[i]
        for q in range(i + 1, j):
            acc = dt(acc - R[i, q] * y[q])
        d = R[i, i] if R[i, i] != 0 else dt(1)
        y[i] = dt(acc / d)
    return y


def gmres(operator: Callable, b, x0, precond: Callable, rtol: float,
          atol: float, max_iter: int, bnorm=None,
          restart: int = 32) -> SolveResult:
    """Right-preconditioned restarted GMRES(m) with modified Gram-Schmidt
    and Givens rotations; ``iters`` counts Arnoldi steps (operator
    applies, PETSc's count). Each cycle restarts from the true residual,
    and a cycle that takes no step still advances the count by one.

    The Krylov vectors and the Gram-Schmidt products stay on the device;
    one read per Arnoldi step brings the new Hessenberg column to the host,
    where the rotations and the least-squares solve run in the solve's
    dtype (numpy scalars round as the device does)."""
    if bnorm is None:
        bnorm = torch.sqrt(_dot(b, b))
    bn = float(bnorm)
    tol = max(rtol * bn, atol)
    m = int(restart)
    dt = np.float64 if b.dtype == torch.float64 else np.float32
    eps = float(np.finfo(dt).eps)

    def cycle(x, r, beta):
        """One GMRES(m) cycle from x with true residual r, |r| = beta."""
        V = [r / (beta if beta > 0 else 1.0)]
        R = np.zeros((m, m), dt)
        cs, sn = np.zeros(m, dt), np.zeros(m, dt)
        g = np.zeros(m + 1, dt)
        g[0] = beta
        j, res = 0, beta
        while j < m and res > tol:
            w = operator(precond(V[j]))
            hs = []
            for i in range(j + 1):
                hi = _dot(V[i], w)
                w = w - hi * V[i]
                hs.append(hi)
            hs.append(torch.sqrt(_dot(w, w)))
            hcol = np.zeros(m + 1, dt)
            hcol[:j + 2] = torch.stack(hs).cpu().numpy()   # the host read
            h_next = hcol[j + 1]
            for i in range(j):
                t0 = dt(cs[i] * hcol[i] + sn[i] * hcol[i + 1])
                t1 = dt(-sn[i] * hcol[i] + cs[i] * hcol[i + 1])
                hcol[i], hcol[i + 1] = t0, t1
            hj, hj1 = hcol[j], hcol[j + 1]
            denom = np.sqrt(dt(hj * hj + hj1 * hj1))
            c, s_ = ((dt(hj / denom), dt(hj1 / denom)) if denom > 0
                     else (dt(1), dt(0)))
            cs[j], sn[j] = c, s_
            hcol[j], hcol[j + 1] = dt(c * hj + s_ * hj1), dt(0)
            R[:, j] = hcol[:m]
            gj = g[j]
            g[j], g[j + 1] = dt(c * gj), dt(-s_ * gj)
            res = abs(float(g[j + 1]))
            # lucky breakdown (h_next ~ 0): keep a zero vector; res is ~0
            # already, so the cycle ends
            V.append(w / float(h_next) if h_next > eps * beta
                     else torch.zeros_like(w))
            j += 1
        if j == 0:
            return x, 0
        y = _back_substitute(R, g, j, dt)
        dx = torch.tensordot(torch.as_tensor(y, device=b.device),
                             torch.stack(V[:j]), dims=1)
        return x + precond(dx), j

    x = x0
    r = b - operator(x0)
    rnorm = float(torch.sqrt(_dot(r, r)))
    k = 0
    while k < max_iter and rnorm > tol:
        x, j = cycle(x, r, rnorm)
        r = b - operator(x)
        rnorm = float(torch.sqrt(_dot(r, r)))
        k += max(j, 1)
    # zero-RHS guard only: with bnorm == 0 the tolerance is atol, which
    # fp noise of the recomputed residual may miss
    bfull = float(torch.sqrt(_dot(b, b)))
    floor = 64.0 * eps * bfull if bn <= eps * bfull else 0.0
    return SolveResult(x=x, iters=k, resnorm=rnorm,
                       converged=rnorm <= max(tol, floor))


SOLVERS = {"cg": pcg, "bicgstab": bicgstab, "gmres": gmres}


def solver_kwargs(cfg) -> dict:
    """The per-solver options of the reference's dispatch."""
    if cfg.solver == "gmres":
        return {"restart": cfg.gmres_restart}
    if cfg.solver == "cg" and cfg.precond == "tree":
        return {"n_restarts": cfg.cg_restarts}
    return {}


def free_mask(model, anchored=None):
    return model.free_nodes if anchored is None \
        else model.free_nodes & anchored


def point_jacobi_inverse(blocks):
    """(N, 3) inverse diagonal of the blocks; a zero entry reads as 1."""
    d = torch.diagonal(blocks, dim1=1, dim2=2)
    return torch.where(d != 0, 1.0 / torch.where(d != 0, d, 1.0), 1.0)


def compute_tree_factor(model, active, cfg, anchored=None, free_chain=None,
                        chain_act_b=None, jump_act_b=None):
    """The per-solve tree-PC factorization, exposed so the ramp can
    reuse it across steps whose active mask did not change. With
    tree_coarse_weight > 0 it carries the coarse inverse too. None when no
    node is free (the preconditioner is then the identity)."""
    from .tree_factor import tree_factor_fast
    if model.tree_fast is None:
        return None
    free = free_mask(model, anchored)
    free_p = free[model.chain.perm] if free_chain is None else free_chain
    reg_pc = max(cfg.reg, cfg.tree_reg_rel * model.tree.meta.k_scale)
    factor = tree_factor_fast(model.tree, model.tree_fast, model.chain,
                              active, free, free_p, reg_pc, model.conn,
                              chain_act_b=chain_act_b,
                              jump_act_b=jump_act_b,
                              launch=model.pcr_launch)
    if cfg.tree_coarse_weight > 0.0:
        nb, kblk, _, _ = cluster_layout(model.n_nodes, cfg)
        factor = replace(factor, coarse_ainv=coarse_inverse(
            model, active, free, cfg, nb, kblk))
    return factor


def chain_preconditioner(model, active, cfg, free, tree_factor_val=None,
                         free_chain=None, chain_act_b=None, jump_act_b=None):
    """The preconditioner of ``cfg.precond`` on chain-ordered (3, N) planes.

    'tree' is the forest solve on the slot positions and the identity on
    the grip positions after them, plus tree_coarse_weight times the
    coarse correction when the weight is > 0 (``tree_factor_val``, a
    compute_tree_factor result, saves the factorization; ``free_chain``,
    ``chain_act_b`` and ``jump_act_b`` the masks' gathers). 'coarse' is the
    3x3 block inverse plus the coarse correction; 'jacobi' is point-Jacobi
    (fault C1)."""
    perm = model.chain.perm
    if cfg.precond == "none":
        return lambda r: r
    if cfg.precond == "tree":
        from .tree_factor import tree_apply_chain_planes
        factor = (tree_factor_val if tree_factor_val is not None
                  else compute_tree_factor(model, active, cfg, free,
                                           free_chain=free_chain,
                                           chain_act_b=chain_act_b,
                                           jump_act_b=jump_act_b))
        S = model.tree.n_slots
        weight = float(cfg.tree_coarse_weight)
        coarse = None if weight <= 0.0 else coarse_space(
            model, active, cfg, free,
            None if factor is None else factor.coarse_ainv)

        def pc(r):
            z = r if factor is None else torch.cat(
                [tree_apply_chain_planes(model.tree, factor, r,
                                         model.pcr_launch), r[:, S:]],
                dim=1)
            return z if coarse is None else z + weight * coarse.apply(r)

        return pc
    blocks = diag_blocks(model, active, cfg, free)
    if cfg.precond == "jacobi":
        inv_d = point_jacobi_inverse(blocks)[perm].T.contiguous()
        return lambda r: r * inv_d
    c9 = block_planes(invert_blocks(blocks)[perm])
    if cfg.precond == "block_jacobi":
        return lambda r: mv3_planes(c9, r)
    coarse = coarse_space(model, active, cfg, free)
    return lambda r: mv3_planes(c9, r) + coarse.apply(r)


def make_preconditioner(model, active, cfg, free_nodes=None,
                        tree_factor_val=None) -> Callable:
    """The preconditioner of ``cfg.precond`` on node-major (N, 3): the
    residual is gathered into chain order, preconditioned there
    (``chain_preconditioner``) and scattered back. For 'tree' the port's
    fast factor stands in for the reference's node-space tree_factor /
    tree_apply, which compute the same factor by another route."""
    free = model.free_nodes if free_nodes is None else free_nodes
    plan = model.chain
    pc = chain_preconditioner(model, active, cfg, free, tree_factor_val)
    return lambda r: pc(r[plan.perm].T.contiguous()).T[plan.inv_perm]


def check_config(cfg) -> None:
    """Raise ValueError for a solver, preconditioner or operator name the
    reference does not have."""
    for field, names in (("solver", SOLVER_NAMES),
                         ("precond", PRECOND_NAMES),
                         ("operator", OPERATOR_NAMES)):
        if getattr(cfg, field) not in names:
            raise ValueError(f"{field}={getattr(cfg, field)!r}: expected "
                             f"one of {names}")


def _node_solve(model, active, dy_top, dy_bot, x0, cfg, anchored,
                tree_factor_val) -> SolveResult:
    """The node-space path (operator 'ell' or 'scatter')."""
    from .bc import bc_operator, bc_rhs, prescribed_values
    free = free_mask(model, anchored)
    u_k = prescribed_values(model, dy_top, dy_bot)
    operator = bc_operator(model, active, cfg, free)
    b = bc_rhs(model, active, u_k, cfg, free)
    precond = make_preconditioner(model, active, cfg, free, tree_factor_val)
    freef = free[:, None]
    # pinned rows start at their prescribed values: zero initial residual
    x0 = torch.where(freef, x0.to(model.dtype), u_k)
    bf = torch.where(freef, b, 0.0)
    bnorm = torch.sqrt(_dot(bf, bf))
    return SOLVERS[cfg.solver](operator, b, x0, precond, cfg.rtol, cfg.atol,
                               cfg.max_iter, bnorm=bnorm,
                               **solver_kwargs(cfg))


def solve_route(model, cfg) -> str:
    """Which path ``solve_displacement`` takes: 'node' (operator 'ell' or
    'scatter'), 'chain_cg' (K5: cg + coarse), 'tree_cg' (K6: cg + tree on a
    model that can run it, ``model.tree_kernel``) or 'hybrid' (the chain
    path, every other combination). The configuration is the solve's own:
    which one built the model does not matter."""
    check_config(cfg)
    if cfg.operator != "chain":
        return "node"
    if cfg.solver == "cg" and cfg.precond == "coarse":
        return "chain_cg"
    if cfg.solver == "cg" and cfg.precond == "tree" and model.tree_kernel:
        return "tree_cg"
    return "hybrid"


def solve_displacement(model, active, dy_top: float, dy_bot: float, x0,
                       cfg, anchored=None,
                       tree_factor_val=None) -> SolveResult:
    """One boundary-value solve of the ramp: K_ff u_f = −K_fk u_k.

    ``anchored`` marks nodes still connected to a grip through active
    elements; the others are pinned to zero (the direct solver's answer).
    ``tree_factor_val`` is a precomputed compute_tree_factor result for the
    same (active, anchored), read by the tree preconditioner.

    Under a profiler the solve is the span ``fea.solve``, the whole-solve
    kernels' stats read inside it the host span ``fea.sync.stats``, and its
    iterations add to the counter ``fea.cg_iters`` (``utils.profiling``)."""
    if not profiling.on():
        return _route_solve(model, active, dy_top, dy_bot, x0, cfg, anchored,
                            tree_factor_val)
    with profiling.span("fea.solve"):
        res = _route_solve(model, active, dy_top, dy_bot, x0, cfg, anchored,
                           tree_factor_val)
        profiling.count("fea.cg_iters", res.iters)
        return res


def _route_solve(model, active, dy_top, dy_bot, x0, cfg, anchored,
                 tree_factor_val) -> SolveResult:
    route = solve_route(model, cfg)
    if route == "node":
        return _node_solve(model, active, dy_top, dy_bot, x0, cfg,
                           anchored, tree_factor_val)
    if route == "chain_cg":
        from .chain_solve import chain_cg_solve
        return chain_cg_solve(model, active, dy_top, dy_bot, x0, cfg,
                              anchored)
    if route == "tree_cg":
        # the whole-solve tree kernel factors inside its launch and has no
        # coarse stage: tree_factor_val and tree_coarse_weight are not read
        from .tree_solve import tree_cg_solve
        return tree_cg_solve(model, active, dy_top, dy_bot, x0, cfg,
                             anchored)
    from .hybrid import chain_path_solve
    return chain_path_solve(model, active, dy_top, dy_bot, x0, cfg, anchored,
                            tree_factor_val=tree_factor_val)
