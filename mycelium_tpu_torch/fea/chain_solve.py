"""The cg + coarse chain solve through the whole-solve kernel K5 (port of
``mycelium_tpu/fea/pallas_cg.py::pallas_chain_solve``).

The model carries the kernel's launch (``model.chain_launch``,
``kernels.ChainCgLaunch``, bound at the model's first cg + coarse solve):
a solve hands it the active mask, the anchored mask, the grips'
displacements and the start vector in the model's own order and reads its
[iterations, |r|, tol] once. The set-up (masks, prescribed values and
start vector in chain order, the 3x3 block-Jacobi inverse, the coarse
matrix in a fixed order, its normalisation and inverse), PCG and the
permutation back all run inside the one launch; on a CPU model the launch
runs the plain version. B5's stop semantics: r·r <= rtol²·|free·b|², no
atol, no stall exit, no restarts.

The clusters are ``coarse_cluster_blocks`` wide here as on every route; the
reference passes one block per cluster to its kernel, which agrees while
3·n_basis·NB <= coarse_max_dim.
"""

from __future__ import annotations

from ..kernels.chain_cg import chain_cg_setup_plain, layout_of
from ..utils.profiling import host_span
from .solve import SolveResult


def chain_cg_inputs(model, active, dy_top: float, dy_bot: float, x0, cfg,
                    anchored=None) -> tuple:
    """The arguments of ``kernels.chain_cg_plain`` for one solve: the plain
    set-up (what the kernel's first phases compute on the card)."""
    nbc, width, nbas = layout_of(model.n_nodes, cfg)
    plan = model.chain
    s = chain_cg_setup_plain(
        plan, model.coarse_plans.get(nbc, width, nbas),
        model.free_nodes, model.top_nodes, model.bot_nodes, active, anchored,
        dy_top, dy_bot, x0, cfg.reg)
    x0_p = x0.to(model.dtype)[plan.perm].T.contiguous()
    return (plan, s["uk"], x0_p, s["freem"], s["cact"], s["jact"], s["c9"],
            s["ainv"], s["s"], nbc, width, nbas == 2, cfg.rtol, cfg.reg,
            cfg.max_iter)


def chain_cg_solve(model, active, dy_top: float, dy_bot: float, x0, cfg,
                   anchored=None) -> SolveResult:
    """``x`` of the result is a buffer of the model's launch on the card:
    valid through the next solve on this model, overwritten by the one
    after (``kernels.ChainCgLaunch``)."""
    x, stats = model.chain_launch.solve(active, anchored, dy_top, dy_bot, x0,
                                        cfg)
    with host_span("fea.sync.stats"):
        iters, rnorm, tol = stats.tolist()
    return SolveResult(x=x, iters=int(iters), resnorm=rnorm,
                       converged=rnorm <= tol)
