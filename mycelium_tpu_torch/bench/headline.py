"""The headline bench: the 22,125-DOF cold-solve median, the 309k-DOF
solve and the 309k-DOF 40-step ramp, under the keys of the root
``bench.py`` (its port).

    python -m mycelium_tpu_torch.bench.headline [--device cpu]
        [--mesh-dir DIR]
    MYC_BENCH_SMALL=1 python -m mycelium_tpu_torch.bench.headline ...

Prints one JSON line:

1. the headline, ``metric`` ``pcg_cold_solve_22125dof_median``: the mesh
   of ``--mesh-dir`` (a results directory with ``nodes.csv`` and
   ``elements.csv``, as the reference archives its largest run) where
   given, else ``meshes.synthetic_mesh(7375)``, under
   ``hybrid_fea_config(warm_start=False)`` (``bench.py:98-100``, default
   grips); ``value`` is the median of 5 windows of 16 back-to-back cold
   ``solve_displacement`` calls, after one warm-up, per solve in ms
   (``bench/scaling.py::timed_cold_solves``: CUDA events on the card, the
   host clock between two synchronisations on the CPU); ``vs_baseline`` is
   164.0 over it, 164.0 ms being the reference's PETSc cg + icc median on
   a CPU node (``BASELINE.md``); then the roofline keys of
   ``bench/roofline.py`` at the last solve's iterations and ``route``;
2. unless ``MYC_BENCH_SMALL`` is set: the 309k-DOF cold solve, the row of
   ``bench/scaling.py::scaling_size`` on ``synthetic_mesh(103000)``
   (``solve_ms_309k``, ``cg_iters_309k``, ``achieved_gbps_309k``,
   ``roofline_frac_309k``, ``route_309k``), with ``vs_baseline_309k`` =
   164.0 · n_dof / 22,125 over ``solve_ms_309k`` (the reference's solve
   time scales linearly in DOF);
3. unless ``MYC_BENCH_SMALL`` is set: the 40-step ramp
   (``fea/ramp.py::run_ramp_async``) on the same mesh under
   ``ramp_config``, its model built once, one ramp untimed, then the
   median of 3 on the host clock between two synchronisations
   (``ramp_s_309k``); ``ramp_vs_baseline_309k`` is 71.76 s (the
   reference's CPU ``runtime.txt`` of the ramp at 22,125 DOF) · 3N /
   22,125 over it, and ``ramp_steps_309k`` the last ramp's recorded steps
   (fewer than 40 where the network fractures through);
4. ``impl`` ("torch") and ``device`` (the card's name, or "cpu").

``bench.py``'s own roundings are kept (``value`` to 3 decimals,
``vs_baseline`` and ``vs_baseline_309k`` to 2, ``ramp_s_309k`` to 2,
``ramp_vs_baseline_309k`` to 1); the numbers taken from the scaling row
and the roofline keys stand as the port's rows give them, not rounded. A
part that fails raises: there is no fallback and no error key. No
``torch.profiler`` window is opened: one slows every later launch of the
process.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time
from typing import NamedTuple

import numpy as np

from ..devices import DEFAULT_DEVICE, resolve
from .growth_scale import device_name, sync
from .scaling import ScalingSolve, scaling_config, scaling_size, \
    timed_cold_solves

METRIC = "pcg_cold_solve_22125dof_median"
BASELINE_MS = 164.0          # PETSc cg + icc, 22,125 DOF, a CPU node
BASELINE_DOF = 22125.0
BASELINE_RAMP_S = 71.76      # the reference's 40-step ramp, 22,125 DOF
N_CHAIN = 16                 # cold solves a window (22k)
WINDOWS = 5
WARM = 1
BIG_CHAIN = 8                # scaling_size's solves a window (309k)
RAMPS = 3                    # timed ramps, after one untimed
SMALL_ENV = "MYC_BENCH_SMALL"


class Headline(NamedTuple):
    """The JSON row, with what the row's numbers were read from."""
    row: dict
    ms: float                 # the headline's median, not rounded
    ramp_s: float             # the ramps' median, not rounded (or None)
    solve: ScalingSolve       # the headline's last cold solve
    coords: np.ndarray        # the headline's mesh
    conn: np.ndarray
    ramp_model: object        # None when MYC_BENCH_SMALL is set
    ramp_cfg: object
    ramps: list               # the RampResults, the untimed one first


def ramp_config(coords):
    """``bench.py:190-194``'s ramp configuration on the mesh ``coords``:
    the scaling configuration (float32, rtol 1e-6, chain, tree, coarse
    weight 0.25, ``tree_reg_rel`` 1e-7, grips 0.3 of the y extent) with
    warm starts, and ``use_pallas`` and ``pallas_vmem_limit_mb`` 120, which
    only the JAX package reads, so that it equals the reference's."""
    return dataclasses.replace(scaling_config(coords), warm_start=True,
                               use_pallas=True, pallas_vmem_limit_mb=120.0)


def headline_solve(coords, conn, device) -> tuple:
    """(the 22k row, median ms, ``ScalingSolve``)."""
    from ..config import hybrid_fea_config
    from ..fea.model import build_model
    from ..fea.solve import solve_route
    from .roofline import roofline_row
    cfg = hybrid_fea_config(warm_start=False)
    model = build_model(coords, conn, cfg, device)
    ms, s = timed_cold_solves(model, cfg, cfg.displacement_max, N_CHAIN,
                              WINDOWS, WARM)
    row = {"metric": METRIC, "value": round(ms, 3), "unit": "ms",
           "vs_baseline": round(BASELINE_MS / ms, 2)}
    row.update(roofline_row(model, s.iters, ms / 1e3))
    row["route"] = solve_route(model, cfg)
    return row, ms, s


def big_solve(coords, conn, device) -> dict:
    """The 309k keys of the cold solve."""
    big, _ = scaling_size(coords, conn, n_chain=BIG_CHAIN, device=device)
    ref_ms = BASELINE_MS * big["n_dof"] / BASELINE_DOF
    return {"solve_ms_309k": big["solve_ms"],
            "vs_baseline_309k": round(ref_ms / big["solve_ms"], 2),
            "route_309k": big["route"],
            "cg_iters_309k": big["cg_iters"],
            "achieved_gbps_309k": big["achieved_gbps"],
            "roofline_frac_309k": big["roofline_frac"]}


def big_ramp(coords, conn, device) -> tuple:
    """(the median seconds of the timed ramps, model, configuration, the
    RampResults)."""
    from ..fea.model import build_model
    from ..fea.ramp import run_ramp_async
    cfg = ramp_config(coords)
    model = build_model(coords, conn, cfg, device)
    ramps = [run_ramp_async(coords, conn, cfg, model=model)]
    secs = []
    for _ in range(RAMPS):
        sync(device)
        t0 = time.perf_counter()
        ramps.append(run_ramp_async(coords, conn, cfg, model=model))
        sync(device)
        secs.append(time.perf_counter() - t0)
    return statistics.median(secs), model, cfg, ramps


def run(device=DEFAULT_DEVICE, n_small: int = 7375, n_big: int = 103000,
        mesh_dir: str | None = None) -> Headline:
    """The headline's parts in ``bench.py``'s order; the defaults are the
    card run."""
    from ..io import read_mesh_dir
    from ..meshes import synthetic_mesh
    device = resolve(device)
    coords, conn = read_mesh_dir(mesh_dir) if mesh_dir \
        else synthetic_mesh(n_small)
    row, ms, solve = headline_solve(coords, conn, device)
    ramp_s = ramp_model = ramp_cfg = None
    ramps = []
    if not os.environ.get(SMALL_ENV):
        coords_b, conn_b = synthetic_mesh(n_big)
        row.update(big_solve(coords_b, conn_b, device))
        ramp_s, ramp_model, ramp_cfg, ramps = big_ramp(coords_b, conn_b,
                                                       device)
        ref_s = BASELINE_RAMP_S * (3 * coords_b.shape[0]) / BASELINE_DOF
        row.update(ramp_s_309k=round(ramp_s, 2),
                   ramp_vs_baseline_309k=round(ref_s / ramp_s, 1),
                   ramp_steps_309k=int(ramps[-1].force_disp.shape[0]))
    row.update(impl="torch", device=device_name(device))
    return Headline(row, ms, ramp_s, solve, coords, conn, ramp_model,
                    ramp_cfg, ramps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="mycelium_tpu_torch.bench.headline", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=("cuda", "cpu"),
                    default=DEFAULT_DEVICE)
    ap.add_argument("--mesh-dir", default=None,
                    help="a results directory to read the 22k mesh from "
                         "(default: synthetic_mesh(7375))")
    args = ap.parse_args(argv)
    print(json.dumps(run(args.device, mesh_dir=args.mesh_dir).row),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
