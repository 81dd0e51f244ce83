"""The quasi-static tensile pull test (port of ``mycelium_tpu/fea/ramp.py``:
``RampResult``, ``ramp_step``, ``post_solve``, ``anchored_mask_host`` and
the ``run_ramp`` loop).

40-step displacement ramp, dy = ±displacement_max·step/(n_steps−1): solve
under grip BCs, reactions with the pre-BC stiffness, axial strains on the
undeformed geometry, deactivate elements with |strain| > max_strain,
record force–displacement, stop early once the network has fully
fractured. The tree-PC factorization is reused across steps whose active
mask did not change; a fracture event refreshes the grip reachability (on
the host, scipy connected components) and the factorization.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from .elements import element_strain
from .model import FeaModel, apply_stiffness, build_model
from .solve import compute_tree_factor, solve_displacement


class RampResult(NamedTuple):
    stress_record: np.ndarray    # (n_rec, E)
    active_record: np.ndarray    # (n_rec, E) bool
    disp_record: np.ndarray      # (n_rec, n_dof) DOF order n0x, n0y, ...
    force_disp: np.ndarray       # (n_rec, 2) [2*dy, total_force]
    solve_seconds: np.ndarray    # (n_rec,)
    cg_iters: np.ndarray         # (n_rec,)
    total_seconds: float


class SolveDivergedError(RuntimeError):
    """A ramp solve failed to converge: run_ramp refuses to record it."""


def _step_factors(cfg, step: int):
    factor = step / (cfg.n_steps - 1)
    return cfg.displacement_max * factor, -cfg.displacement_max * factor


def _check_converged(converged: bool, step: int, resnorm: float) -> None:
    if not converged:
        raise SolveDivergedError(
            f"solver diverged at ramp step {step + 1}: |r| = {resnorm:.3e} "
            "after max_iter iterations")


def anchored_mask_host(conn: np.ndarray, active: np.ndarray,
                       grip: np.ndarray) -> np.ndarray:
    """Nodes reachable from a grip through active elements (scipy
    connected components). Unreachable nodes form fracture islands whose
    exact solution is zero; the solve pins them."""
    from scipy.sparse import coo_matrix
    from scipy.sparse.csgraph import connected_components
    n = grip.shape[0]
    act = conn[active.astype(bool)]
    adj = coo_matrix((np.ones(len(act)), (act[:, 0], act[:, 1])),
                     shape=(n, n))
    _, labels = connected_components(adj, directed=False)
    return np.isin(labels, np.unique(labels[grip]))


def post_solve(model: FeaModel, cfg, u, active):
    """Reactions -> stress -> fracture for a solved displacement field."""
    f_react = apply_stiffness(model, u, active)
    total_force = torch.where(model.top_nodes, f_react[:, 1], 0.0).sum()
    strain = element_strain(u, model.conn, model.geom)
    stress = torch.where(active, cfg.e_mod * strain, 0.0)
    active_new = active & (strain.abs() <= cfg.max_strain)
    return stress, active_new, total_force


def ramp_step(model: FeaModel, cfg, active, x0, dy_top: float,
              dy_bot: float, anchored=None, tree_factor_val=None):
    """One ramp step: solve -> reactions -> stress -> fracture."""
    res = solve_displacement(model, active, dy_top, dy_bot, x0, cfg,
                             anchored, tree_factor_val=tree_factor_val)
    stress, active_new, total_force = post_solve(model, cfg, res.x, active)
    return (res.x, stress, active_new, total_force, res.iters, res.resnorm,
            res.converged)


def run_ramp(coords, conn, cfg, device=None,
             model: Optional[FeaModel] = None) -> RampResult:
    """Python-loop pull-test ramp with warm starts, factor reuse and the
    reference's early stop on full fracture. Give ``model`` or
    ``device``."""
    t0 = time.time()
    if model is None:
        if device is None:
            raise ValueError("run_ramp needs a model or a device")
        model = build_model(coords, conn, cfg, device)
    dtype, dev = model.dtype, model.device
    conn_np = model.conn.cpu().numpy()
    grip_np = (model.top_nodes | model.bot_nodes).cpu().numpy()

    active_np = np.ones(model.n_elems, bool)
    active = torch.ones(model.n_elems, dtype=torch.bool, device=dev)
    u_prev = torch.zeros((model.n_nodes, 3), dtype=dtype, device=dev)
    prev_factor = 0.0
    stress_rec, active_rec, disp_rec, fd_rec = [], [], [], []
    solve_secs, iters_rec = [], []

    def anchored_for(act_np):
        return torch.as_tensor(anchored_mask_host(conn_np, act_np, grip_np),
                               device=dev)

    anchored = anchored_for(active_np)
    fac = compute_tree_factor(model, active, cfg, anchored)

    for step in range(cfg.n_steps):
        dy_top, dy_bot = _step_factors(cfg, step)
        # warm start: the response is linear between fracture events
        factor = step / (cfg.n_steps - 1)
        if cfg.warm_start and prev_factor > 0:
            x0 = u_prev * (factor / prev_factor)
        else:
            x0 = torch.zeros_like(u_prev)
        ts = time.time()
        u, stress, active_new, total_force, iters, resnorm, converged = \
            ramp_step(model, cfg, active, x0, dy_top, dy_bot, anchored, fac)
        _check_converged(converged, step, resnorm)
        solve_secs.append(time.time() - ts)

        active_new_np = active_new.cpu().numpy()
        active_rec.append(active_new_np)
        fd_rec.append([dy_top - dy_bot, float(total_force)])
        iters_rec.append(iters)
        stress_rec.append(stress.cpu().numpy())
        disp_rec.append(u.cpu().numpy().reshape(-1))

        if not np.array_equal(active_new_np, active_np):
            # fracture changed the topology: refresh grip reachability and
            # the tree-PC factorization
            anchored = anchored_for(active_new_np)
            fac = compute_tree_factor(model, active_new, cfg, anchored)
        u_prev, active, active_np, prev_factor = \
            u, active_new, active_new_np, factor
        if not active_new_np.any():
            break   # early stop on full fracture

    return RampResult(
        stress_record=np.stack(stress_rec),
        active_record=np.stack(active_rec),
        disp_record=np.stack(disp_rec),
        force_disp=np.asarray(fd_rec, dtype=np.float64),
        solve_seconds=np.asarray(solve_secs),
        cg_iters=np.asarray(iters_rec, dtype=np.int64),
        total_seconds=time.time() - t0)
