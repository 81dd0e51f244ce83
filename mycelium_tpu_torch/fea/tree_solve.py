"""The cg + tree chain solve through the whole-solve kernel K6 (port of
``mycelium_tpu/fea/pallas_tree.py::pallas_tree_solve``).

The model carries the kernel's bound launch (``model.tree_launch``,
``kernels.TreeCgLaunch``): a solve hands it the active mask, the free mask
(one ``&`` with the anchored mask), the grips' displacements and the start
vector in the model's own order, and reads its [iterations, |r|, tol] once.
The set-up (masks, prescribed values and start vector in chain order, the
forest diagonal with reg_pc = max(reg, tree_reg_rel·k_scale), the left-edge
and the attachment element couplings), the factorization, the
preconditioner, PCG and the permutation back all run inside the one launch;
on a CPU model the launch runs the plain version. B4's semantics: every
level on PCR, no dense tail, no coarse stage (the configuration's
``tree_coarse_weight`` is not read), stop on r·r <= rtol²·|free·b|², no
atol, no restarts; and the stall exit of the reference's ``pcg``, which
runs the solves above B4's memory gate that K6 takes here: ``converged``
is pcg's verdict (on the tolerance, or on a plateau within STALL_ACCEPT
times it).
"""

from __future__ import annotations

from ..kernels.tree_cg import stall_converged, tree_cg_setup_plain
from ..utils.profiling import host_span
from .solve import SolveResult, free_mask


def preconditioner_reg(model, cfg) -> float:
    return max(cfg.reg, cfg.tree_reg_rel * model.tree.meta.k_scale)


def tree_cg_inputs(model, active, dy_top: float, dy_bot: float, x0, cfg,
                   anchored=None) -> tuple:
    """The arguments of ``kernels.tree_cg_plain`` for one solve: the plain
    set-up (what the kernel's first phase computes on the card)."""
    s = tree_cg_setup_plain(
        model.chain, model.tree, model.tree_fast, model.conn,
        model.top_nodes, model.bot_nodes, active, free_mask(model, anchored),
        dy_top, dy_bot, x0, preconditioner_reg(model, cfg))
    return (model.chain, model.tree, model.tree_tables, s["uk"], s["x0"],
            s["freem"], s["cact"], s["jact"], s["d9"], s["bel"], s["katt"],
            cfg.rtol, cfg.reg, cfg.max_iter)


def tree_cg_solve(model, active, dy_top: float, dy_bot: float, x0, cfg,
                  anchored=None) -> SolveResult:
    """``x`` of the result is a buffer of the model's launch on the card:
    valid through the next solve on this model, overwritten by the one
    after (``kernels.TreeCgLaunch``)."""
    if model.tree_launch is None:
        raise ValueError("this model cannot run the whole-solve tree kernel "
                         "(float64, no forest level, or past its memory "
                         "guard): fea/model.py::tree_kernel_fits")
    x, stats = model.tree_launch.solve(
        active, free_mask(model, anchored), dy_top, dy_bot, x0, cfg.rtol,
        cfg.reg, preconditioner_reg(model, cfg), cfg.max_iter)
    with host_span("fea.sync.stats"):
        iters, rnorm, tol, since = stats.tolist()
    return SolveResult(x=x, iters=int(iters), resnorm=rnorm,
                       converged=stall_converged(rnorm, tol, int(since)))
