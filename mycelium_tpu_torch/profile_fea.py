"""Where a cold pull-test solve's time goes on the card, on each route.

    python -m mycelium_tpu_torch.profile_fea [--nodes 7375 33000 103000]
        [--reps 5] [--out DIR]

For each synthetic mesh (``meshes.synthetic_mesh``, the configuration of
``hybrid_fea_config``, coarse weight 0) it solves the full-displacement
system cold through the whole-solve tree kernel (K6, ``model.tree_kernel``
forced on: one ``&`` for the free mask, the launch bound to the model, one
read of its stats) and through the hybrid (K1-K3 and a CG loop on the host,
forced off), and per route reports:

1. wall milliseconds a solve, the card synchronised at the end (median of
   ``--reps``), the iterations and |r|;
2. the host syncs a solve that PyTorch itself reports
   (``torch.cuda.set_sync_debug_mode``), by source line;
3. from a ``torch.profiler`` trace of ``--reps`` solves (after one profiled
   warm-up solve): device operations and device-busy milliseconds a solve,
   the busy share of pass 1's wall time, and the largest kernels;
4. the 40-step ramp of the mesh on its own route (``run_ramp`` and
   ``run_ramp_async``), wall seconds, and what a ramp step spends beside
   its solve: ``post_solve`` (reactions, stress, fracture), the four
   record reads of ``run_ramp`` and one refresh of the grip reachability,
   wall milliseconds each, synchronised (median of ``--reps``).

Every mesh's wall readings (1 and 4) are taken before any mesh's syncs and
traces (2 and 3): a ``torch.profiler`` window slows every later launch of
the process on the host.

Prints one JSON object, the card's name and power limit in it; with
``--out`` it also writes the Chrome traces there. Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import time
import warnings

import numpy as np
import torch

from .config import hybrid_fea_config
from .fea import (build_model, run_ramp, run_ramp_async, solve_displacement,
                  solve_route)
from .fea.model import tree_kernel_bytes
from .fea.ramp import post_solve, refresh_anchored
from .kernels import launch_counts, reset_launch_counts
from .meshes import synthetic_mesh


def _sync():
    torch.cuda.synchronize()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def solve_ms(solve, reps: int):
    """(median wall ms a solve synchronised at the end, the last result)."""
    times, res = [], None
    for _ in range(reps):
        _sync()
        t0 = time.perf_counter()
        res = solve()
        _sync()
        times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times)), res


def syncs_per_solve(solve, reps: int):
    """PyTorch's count of synchronising calls a solve, and by source
    line."""
    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for _ in range(reps):
                solve()
    finally:
        torch.cuda.set_sync_debug_mode("default")
    sites = {}
    for w in caught:
        if "synchroniz" in str(w.message):
            key = f"{os.path.relpath(w.filename)}:{w.lineno}"
            sites[key] = sites.get(key, 0) + 1 / reps
    return sum(sites.values()), sites


def profile(solve, reps: int, wall_ms: float, trace_path):
    from torch.profiler import ProfilerActivity, schedule
    from torch.profiler import profile as tprofile
    _sync()
    with tprofile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                  schedule=schedule(wait=0, warmup=1, active=reps,
                                    repeat=1)) as prof:
        for _ in range(reps + 1):
            solve()
            _sync()
            prof.step()
    # the device events, less the profiler's own step annotations, which
    # it also places on the device timeline
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and not e.name.startswith("ProfilerStep")]
    busy_ms = sum(e.device_time for e in kernels) / 1e3
    by_name = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.device_time / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    if trace_path:
        os.makedirs(os.path.dirname(trace_path), exist_ok=True)
        prof.export_chrome_trace(trace_path)
    return dict(device_busy_ms=busy_ms / reps,
                busy_share=busy_ms / reps / wall_ms,
                device_ops_per_solve=len(kernels) / reps,
                top_kernels_ms_per_solve=[(k[:80], v / reps)
                                          for k, v in top])


def profile_mesh(n_nodes: int, reps: int, out_dir):
    """A generator in two passes: first everything read on the host's clock
    (it yields None when that is done), then the syncs and the traces (it
    yields the mesh's results). ``main`` runs the first pass of every mesh
    before the second of any: a ``torch.profiler`` window slows every later
    launch of the process on the host."""
    coords, conn = synthetic_mesh(n_nodes)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    # the grips of the repository's benchmark: the default length up to
    # 99k DOF, 0.3 of the extent at 309k
    kw = dict(grip_length=0.3 * ext) if n_nodes > 50000 else {}
    cfg = hybrid_fea_config(warm_start=False, **kw)
    model = build_model(coords, conn, cfg, "cuda")
    active = torch.ones(model.n_elems, dtype=torch.bool, device="cuda")
    anchored = refresh_anchored(model, active)
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device="cuda")
    dy = cfg.displacement_max
    off = model.tree.meta.level_offsets
    out = dict(nodes=n_nodes, dof=model.n_dof,
               level_slots=[b - a for a, b in zip(off, off[1:])],
               level_rounds=list(model.tree.meta.level_steps),
               kernel_bytes=tree_kernel_bytes(model),
               default_route=solve_route(model, cfg), routes={})
    solves = {}
    for name, on in (("tree_cg", True), ("hybrid", False)):
        m = dataclasses.replace(model, tree_kernel=on)

        def solve(m=m):
            return solve_displacement(m, active, dy, -dy, x0, cfg, anchored)

        solves[name] = solve
        solve()                                     # build, warm caches
        wall_ms, res = solve_ms(solve, reps)
        reset_launch_counts()
        solve()
        counts = {k: v for k, v in launch_counts().items() if v}
        out["routes"][name] = dict(
            solve_ms=wall_ms, iters=res.iters, resnorm=res.resnorm,
            converged=res.converged, kernel_launches=counts)
    # a ramp step beside its solve, on the cold solve's displacement
    u = solve_displacement(model, active, dy, -dy, x0, cfg, anchored).x

    def records():
        stress, active_new, force = post_solve(model, cfg, u, active)
        return (active_new.cpu(), float(force), stress.cpu(), u.cpu())

    out["step_parts_ms"] = dict(
        post_solve=solve_ms(lambda: post_solve(model, cfg, u, active),
                            reps)[0],
        post_solve_and_record_reads=solve_ms(records, reps)[0],
        refresh_anchored=solve_ms(lambda: refresh_anchored(model, active),
                                  reps)[0])
    ramp_cfg = dataclasses.replace(cfg, warm_start=True)
    run_ramp(coords, conn, ramp_cfg, model=model)   # warm
    for name, fn in (("run_ramp", run_ramp),
                     ("run_ramp_async", run_ramp_async)):
        _sync()
        t0 = time.perf_counter()
        r = fn(coords, conn, ramp_cfg, model=model)
        _sync()
        out[f"{name}_s"] = time.perf_counter() - t0
        out[f"{name}_steps"] = int(r.force_disp.shape[0])
    yield None
    for name, solve in solves.items():
        n_syncs, sites = syncs_per_solve(solve, reps)
        trace = (os.path.join(out_dir, f"fea_{n_nodes}_{name}.json")
                 if out_dir else None)
        out["routes"][name].update(
            host_syncs_per_solve=n_syncs, syncs_by_line=sites,
            **profile(solve, reps, out["routes"][name]["solve_ms"], trace))
    yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, nargs="+",
                    default=[7375, 33000, 103000])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fea: needs a CUDA card")
    runs = [profile_mesh(n, args.reps, args.out) for n in args.nodes]
    for run in runs:            # every wall reading before any trace
        next(run)
    print(json.dumps(dict(card=card_line(), reps=args.reps,
                          meshes=[next(run) for run in runs])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
