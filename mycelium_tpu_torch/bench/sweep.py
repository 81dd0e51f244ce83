"""Solver x preconditioner sweep (port of
``mycelium_tpu/bench/sweep.py::run_solver_sweep``).

The reference benchmarks 3 KSP types x 5 PETSc preconditioners per ramp
step and writes step,solver,pc,trial,runtime_ms
(src/fea_petsc_solverAndPC.cpp:221-223,326-391). The sweep runs the same
3x5 matrix, (cg, bicgstab, gmres) x (tree, coarse, block_jacobi, jacobi,
none), over the same ramp, with the same CSV schema and its ``_meta.json``
sidecar. The physics advances with the primary configuration's solution.

Each trial times one cold solve (x0 = 0) of the current ramp system,
reactions and fracture included, on the host clock between two
synchronisations with the card. Each combination is solved once untimed
on the first step (dy = 0: a solve that ends at once but builds every
table and touches every kernel of the combination) before any trial is
timed. The reference's chained trials (``chain_trials`` and the
``x0 * 1e-30`` cold restart) work around its TPU relay and are not
ported: every row is one solve, ``chain_len`` 1.

Routes on the chain operator (``fea/solve.py::solve_route``, written into
the sidecar per combination): cg + coarse runs the whole-solve kernel K5
(the port of ``pallas_cg.py::_cg_kernel``); cg + tree, in its leg and as
the primary configuration, runs the whole-solve tree kernel K6 (the port of
``pallas_tree.py::_tree_cg_kernel``, no coarse stage) on a model that can
run it (``model.tree_kernel``), as the reference does where its tables
fit, and the hybrid (K1-K3) with ``tree_coarse_weight`` applied
otherwise; every other combination runs the chain path.
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..devices import DEFAULT_DEVICE
from ..fea.model import build_model
from ..fea.ramp import SolveDivergedError, anchored_mask_host, ramp_step
from ..fea.solve import solve_route
from ..io.writers import write_sweep_results

DEFAULT_SOLVERS = ("cg", "bicgstab", "gmres")
DEFAULT_PCS = ("tree", "coarse", "block_jacobi", "jacobi", "none")


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_solver_sweep(coords, conn, cfg,
                     solvers: Sequence[str] = DEFAULT_SOLVERS,
                     pcs: Sequence[str] = DEFAULT_PCS,
                     trials: int = 5,
                     out_csv: Optional[str] = None,
                     verbose: bool = False,
                     return_meta: bool = False,
                     device=DEFAULT_DEVICE):
    """Returns rows (step, solver, pc, trial, runtime_ms), and the sidecar
    dict too with ``return_meta``. With ``out_csv`` the rows go to that
    CSV and the sidecar to ``<out_csv stem>_meta.json``: per combination
    the converged-step count and the median and largest iteration count of
    its last solve of each step. The model is built on ``device`` (the
    card unless the caller passes "cpu")."""
    model = build_model(coords, conn, cfg, device)
    dev, dtype = model.device, model.dtype
    combos = [(s, pc) for s in solvers for pc in pcs]
    ccfg = {(s, pc): dataclasses.replace(cfg, solver=s, precond=pc,
                                         warm_start=False)
            for s, pc in combos}

    conn_np = model.conn.cpu().numpy()
    grip_np = (model.top_nodes | model.bot_nodes).cpu().numpy()
    active_np = np.ones(model.n_elems, bool)
    active = torch.ones(model.n_elems, dtype=torch.bool, device=dev)
    anchored = torch.as_tensor(
        anchored_mask_host(conn_np, active_np, grip_np), device=dev)
    zeros = torch.zeros((model.n_nodes, 3), dtype=dtype, device=dev)
    u_prev = zeros
    prev_factor = 0.0

    rows: List[Tuple] = []
    stats = {key: {"iters": [], "converged": []} for key in combos}
    warmed = set()
    for step in range(cfg.n_steps):
        factor = step / (cfg.n_steps - 1)
        dy = cfg.displacement_max * factor
        for key in combos:
            if key not in warmed:
                ramp_step(model, ccfg[key], active, zeros, dy, -dy, anchored)
                warmed.add(key)
            out = None
            for trial in range(trials):
                _sync(dev)
                t0 = time.perf_counter()
                out = ramp_step(model, ccfg[key], active, zeros, dy, -dy,
                                anchored)
                _sync(dev)
                rows.append((step, key[0], key[1], trial,
                             (time.perf_counter() - t0) * 1e3))
            if out is not None:        # trials=0 times nothing (fault C3)
                stats[key]["iters"].append(int(out[4]))
                stats[key]["converged"].append(bool(out[6]))
        if verbose:
            last = [r for r in rows if r[0] == step]
            per = {}
            for r in last:
                per.setdefault(f"{r[1]}+{r[2]}", []).append(r[4])
            line = " ".join(f"{k}:{float(np.median(v)):.1f}"
                            for k, v in per.items())
            if last:
                best = min(last, key=lambda r: r[4])
                line = f"best {best[1]}+{best[2]} {best[4]:.2f} ms | " + line
            print(f"step {step}: {line}", flush=True)

        # advance the physics with the primary configuration
        x0 = u_prev * (factor / prev_factor) \
            if (cfg.warm_start and prev_factor > 0) else zeros
        u, _, active_new, _, _, resnorm, converged = ramp_step(
            model, cfg, active, x0, dy, -dy, anchored)
        if not converged:
            raise SolveDivergedError(
                f"primary solver diverged at sweep step {step + 1}: "
                f"|r| = {resnorm:.3e}")
        active_new_np = active_new.cpu().numpy()
        if not np.array_equal(active_new_np, active_np):
            anchored = torch.as_tensor(
                anchored_mask_host(conn_np, active_new_np, grip_np),
                device=dev)
        # a copy: the legs of the next step solve on the same model, and a
        # solve on the whole-solve tree kernel returns a buffer that the
        # solve after next overwrites (kernels.TreeCgLaunch)
        u_prev, active, active_np, prev_factor = \
            u.clone(), active_new, active_new_np, factor
        if not active_new_np.any():
            break

    meta = {
        "row_semantics": "runtime_ms is one timed cold solve (chain_len "
                         "1): the solve, reactions and fracture between "
                         "two synchronisations with the device",
        "combos": {
            f"{s}+{pc}": {
                "chain_len": 1,
                "route": solve_route(model, ccfg[(s, pc)]),
                "converged_steps": int(sum(st["converged"])),
                "steps": len(st["converged"]),
                "median_iters": float(np.median(st["iters"]))
                if st["iters"] else None,
                "max_iters": int(max(st["iters"])) if st["iters"] else None,
            }
            for (s, pc), st in stats.items()
        },
    }
    if out_csv is not None:
        write_sweep_results(out_csv, rows)
        base, _ = os.path.splitext(out_csv)
        with open(base + "_meta.json", "w") as f:
            json.dump(meta, f, indent=1)
    if return_meta:
        return rows, meta
    return rows
