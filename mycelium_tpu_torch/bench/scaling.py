"""DOF-scaling benchmark: cold PCG solves a second at growing system sizes
(port of ``mycelium_tpu/bench/scaling.py``).

    python -m mycelium_tpu_torch.bench.scaling [n_nodes ...] [--device cpu]

The default sizes are 7,375 and 33,000 nodes (22,125 and 99,000 DOF).
Meshes are ``meshes.synthetic_mesh``: random-walk hyphae that branch,
the mostly-chain topology the chain operator and the forest
preconditioner are built for. The configuration is the reference's:
float32, rtol 1e-6, cold starts, the chain operator, the tree
preconditioner with coarse weight 0.25 and ``tree_reg_rel`` 1e-7, grips
30% of the extent a side (a sliver-gripped random tree is floppy enough
that float32 CG stalls on conditioning). ``cg`` + ``tree`` takes the
whole-solve kernel K6 where the model can run it (``fea/solve.py::
solve_route``), else the hybrid.

Each size prints one JSON row: ``n_dof``, ``solve_ms`` (the median of 3
windows of ``n_chain`` back-to-back cold ``solve_displacement`` calls,
after a warm-up, per solve), ``solves_per_sec``, ``cg_iters`` (the last
solve's), ``plan_build_s`` (``build_model``), ``factor_ms`` where the
route's factorization can be called alone (the hybrid; K6 factors inside
its launch), ``route``, the roofline keys of ``bench/roofline.py``,
``impl`` ("torch") and ``device`` (the card's name, or "cpu"). The
numbers are not rounded. On the card a window is timed with CUDA events,
on the CPU with the host clock between two synchronisations.

Every solve is cold: ``solve_displacement`` with no factorization passed
in factors anew on every route (K6 inside its launch, the hybrid through
``compute_tree_factor``), so nothing stands in for the reference's
``xc * 1e-30`` and ``isfinite`` chain, which only keeps XLA from hoisting
the factorization out of its jitted scan. No ``torch.profiler`` window is
opened: one slows every later launch of the process.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from typing import NamedTuple

import numpy as np
import torch

from ..devices import DEFAULT_DEVICE, resolve
from ..utils.profiling import window_ms
from .growth_scale import device_name, sync

DY = 0.02          # grip displacement of each timed solve, +top / -bottom
WARM_CALLS = 2
WINDOWS = 3


class ScalingSolve(NamedTuple):
    """The last timed solve of a size, with what it was solved on."""
    model: object
    cfg: object
    active: torch.Tensor
    anchored: torch.Tensor
    x: torch.Tensor           # (N, 3), a copy of the solve's result
    iters: int


def scaling_config(coords, rtol: float = 1e-6):
    """The reference's scaling configuration for the mesh ``coords``."""
    from ..config import FeaConfig
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    return FeaConfig(dtype="float32", rtol=rtol, warm_start=False,
                     operator="chain", precond="tree",
                     tree_coarse_weight=0.25, tree_reg_rel=1e-7,
                     grip_length=0.3 * ext)


def timed_cold_solves(model, cfg, dy: float, reps: int, windows: int,
                      warm: int) -> tuple:
    """(median ms a cold solve, ``ScalingSolve`` of the last one): the
    full-pull system of ``model`` (grips at +``dy`` / -``dy``, every
    element active, the grips' anchored mask, x0 zero) solved ``warm``
    times, then ``windows`` windows of ``reps`` back-to-back cold
    ``solve_displacement`` calls (``utils.profiling.window_ms``)."""
    from ..fea.ramp import anchored_mask_host
    from ..fea.solve import solve_displacement
    device = model.device
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    anchored = torch.as_tensor(anchored_mask_host(
        model.conn.cpu().numpy(), np.ones(model.n_elems, bool), grip),
        device=device)
    active = torch.ones(model.n_elems, dtype=torch.bool, device=device)
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=device)
    ms, res = window_ms(
        lambda: solve_displacement(model, active, dy, -dy, x0, cfg,
                                   anchored), reps, device, windows, warm)
    return ms, ScalingSolve(model, cfg, active, anchored, res.x.clone(),
                            int(res.iters))


def scaling_size(coords, conn, n_chain: int = 8, rtol: float = 1e-6,
                 device=DEFAULT_DEVICE):
    """One size, on the mesh (``coords``, ``conn``): (the row,
    ``ScalingSolve``)."""
    from ..fea.model import build_model
    from ..fea.solve import compute_tree_factor, solve_route
    from .roofline import roofline_row
    device = resolve(device)
    cfg = scaling_config(coords, rtol)
    sync(device)
    t0 = time.perf_counter()
    model = build_model(coords, conn, cfg, device)
    sync(device)
    build_s = time.perf_counter() - t0
    route = solve_route(model, cfg)

    solve_ms, s = timed_cold_solves(model, cfg, DY, n_chain, WINDOWS,
                                    WARM_CALLS)
    row = {
        "n_dof": model.n_dof,
        "solve_ms": solve_ms,
        "solves_per_sec": 1e3 / solve_ms,
        "cg_iters": s.iters,
        "plan_build_s": build_s,
    }
    if route == "hybrid":
        row["factor_ms"] = window_ms(
            lambda: compute_tree_factor(model, s.active, cfg, s.anchored),
            n_chain, device, WINDOWS, WARM_CALLS)[0]
    row["route"] = route
    row.update(roofline_row(model, row["cg_iters"], solve_ms / 1e3))
    row.update(impl="torch", device=device_name(device))
    return row, s


def run(n_nodes_list, n_chain: int = 8, rtol: float = 1e-6,
        quiet: bool = False, device=DEFAULT_DEVICE) -> list:
    from ..meshes import synthetic_mesh
    rows = []
    for n in n_nodes_list:
        row, _ = scaling_size(*synthetic_mesh(n), n_chain, rtol, device)
        rows.append(row)
        if not quiet:
            print(json.dumps(row), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mycelium_tpu_torch.bench.scaling", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("n_nodes", nargs="*", type=int,
                    help="mesh sizes in nodes (default: 7375 33000)")
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    default=DEFAULT_DEVICE)
    args = ap.parse_args(argv)
    run(args.n_nodes or [7375, 33000], device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
