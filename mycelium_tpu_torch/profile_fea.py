"""Where a cold pull-test solve's time goes on the card, on each route.

    python -m mycelium_tpu_torch.profile_fea [--nodes 7375 33000 103000]
        [--reps 5] [--out DIR] [--ramp-routes]
    python -m mycelium_tpu_torch.profile_fea --grown large medium
    python -m mycelium_tpu_torch.profile_fea --grown CONFIG.json
        [--growth-seeds 42 43] [--reps 5]
    python -m mycelium_tpu_torch.profile_fea --sweep TRIALS
    python -m mycelium_tpu_torch.profile_fea --hybrid-apply [--nodes ...]

For each synthetic mesh (``meshes.synthetic_mesh``, the configuration of
``hybrid_fea_config``, coarse weight 0) it solves the full-displacement
system cold through the whole-solve tree kernel (K6, ``model.tree_kernel``
forced on: one ``&`` for the free mask, the launch bound to the model, one
read of its stats), through the hybrid (K1-K3 and a CG loop on the host,
forced off) and, with cg + coarse (rtol 1e-5, max_iter 3000, the sweep's
K5 leg), through the whole-solve coarse kernel (K5), and per route
reports:

1. wall milliseconds a solve, the card synchronised at the end (median of
   ``--reps``), the iterations and |r|;
2. the host syncs a solve that PyTorch itself reports
   (``torch.cuda.set_sync_debug_mode``), by source line;
3. from a ``torch.profiler`` trace of ``--reps`` solves (after one profiled
   warm-up solve): device operations and device-busy milliseconds a solve,
   the busy share of pass 1's wall time, and the largest kernels; on the
   K5 route also the kernel's device time with the iteration cap at 0, 1
   and 10 and converged, and its slope an iteration;
4. the 40-step ramp of the mesh on its own route (``run_ramp`` and
   ``run_ramp_async``), wall seconds, and what a ramp step spends beside
   its solve: ``post_solve`` (reactions, stress, fracture), the four
   record reads of ``run_ramp`` and one refresh of the grip reachability,
   wall milliseconds each, synchronised (median of ``--reps``); with
   ``--ramp-routes`` the same 40-step fracturing ramp (``run_ramp``) on K6
   and on the forced hybrid: the steps each reached (or where it raised),
   the iterations a step and the largest difference of their records.

Every mesh's wall readings (1 and 4) are taken before any mesh's syncs and
traces (2 and 3): a ``torch.profiler`` window slows every later launch of
the process on the host.

With ``--grown PRESET [PRESET ...]`` it measures fault P6 on networks that
users grow instead: each growth preset grown on the card through
``run_growth``, its network exported (``state_mesh``) and built with
``hybrid_fea_config()``; in place of a preset, a configuration file with
every ``GrowthConfig`` field under ``growth`` and every ``FeaConfig`` field
under ``fea`` (``benchmark/configs/pipeline-*.json``), built with its own
``fea``. Each is grown once a seed of ``--growth-seeds`` (else with
``run_growth``'s default), its stages timed, its K6 bytes
(``tree_kernel_bytes``) beside ``TREE_KERNEL_MAX_BYTES``, the card's
memory peak, and the median ms of ``--reps`` cold solves on K6 and on the
hybrid. Then ``ramp_routes``: the 40-step fracturing ramp
on K6 (every level on PCR) and on the hybrid with the configuration's
``tree_dense_tail`` (the reference's route above its memory gate). Where
no element fractures at the configuration's pull, it names the
displacement at which the first element would (the largest element strain
of the linear solve at full pull, scaled to ``max_strain``) and ramps both
routes again to twice that displacement. Where the two routes' fracture
patterns part there, it says why (``parting``): the stress of the
elements where they first part against the fracture stress and against
the converged solve's, each route's stress error there, the same ramp in
float64 on the CPU at the configuration's rtol and converged (1e-10) as
the arbiter, and both routes again at rtol 1e-7.

With ``--sweep TRIALS`` it runs only the solver sweep instead, on each
mesh: ``run_solver_sweep`` in chip_smoke.py's configuration (3 ramp steps,
rtol 1e-5, max_iter 3000, tree legs with coarse weight 0.25), TRIALS
trials, and per combination the median ms over the loaded steps and the
trials, the route and the iterations. It needs nothing of the package
beyond ``run_solver_sweep``'s arguments and ``utils.profiling.
window_ms``, so the same file can time an older checkout of the package
that has that timer (run it from that checkout's root).

With ``--hybrid-apply`` it measures only the hybrid's tree preconditioner
on each mesh (``hybrid_apply``): one forest apply and one factorization,
their call ms and device operations, whether the dense tail's inverse
has the same bits twice, and the hybrid's cold solve with its device
operations and host syncs. Like ``--sweep`` it can time an older
checkout.

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
from .utils.profiling import device_ops, window_ms


# the sweep's K5 leg (chip_smoke.py, scripts/bench_sweep_tpu.py)
K5_RTOL = 1e-5
K5_MAX_ITER = 3000


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
    kernels = device_ops(prof)
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


def kernel_ms(solve, reps: int, name: str) -> float:
    """Device milliseconds a solve of the kernels whose name holds
    ``name``, from a ``torch.profiler`` trace of ``reps`` solves."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as tprofile
    solve()
    _sync()
    with tprofile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            solve()
        _sync()
    return sum(e.device_time for e in device_ops(prof)
               if name in e.name) / 1e3 / reps


def ramp_routes(coords, conn, cfg, model, recs=None) -> dict:
    """The 40-step fracturing ramp on K6 and on the forced hybrid: steps
    reached, iterations a step, wall seconds, and the largest difference
    of the two routes' records (displacement as a share of its largest
    entry, force, the active masks). ``recs`` (a dict) receives each
    route's ``RampResult``."""
    from .fea.ramp import SolveDivergedError
    out, recs = {}, {} if recs is None else recs
    for name, on in (("tree_cg", True), ("hybrid", False)):
        m = dataclasses.replace(model, tree_kernel=on)
        _sync()
        t0 = time.perf_counter()
        try:
            r = run_ramp(coords, conn, cfg, model=m)
        except SolveDivergedError as e:
            out[name] = dict(raised=str(e))
            continue
        _sync()
        recs[name] = r
        out[name] = dict(steps=int(r.force_disp.shape[0]),
                         iters=r.cg_iters.tolist(),
                         fractured=int((~r.active_record[-1]).sum()),
                         wall_s=time.perf_counter() - t0)
    if len(recs) == 2:
        a, b = recs["tree_cg"], recs["hybrid"]
        n = min(a.force_disp.shape[0], b.force_disp.shape[0])
        out["records"] = dict(
            steps_compared=n,
            disp_rel=float(np.abs(a.disp_record[:n] - b.disp_record[:n]).max()
                           / max(np.abs(b.disp_record[:n]).max(), 1e-300)),
            force_rel=float(np.abs(a.force_disp[:n, 1] - b.force_disp[:n, 1])
                            .max() / max(np.abs(b.force_disp[:n, 1]).max(),
                                         1e-300)),
            active_differ=int((a.active_record[:n]
                               != b.active_record[:n]).sum()))
    return out


def against(r, ref) -> dict:
    """A ramp's fracture pattern against a reference ramp's: the active
    flags that differ over the steps both reached, the first step where
    they do (None: never), and each one's fractured elements at its end."""
    n = min(r.active_record.shape[0], ref.active_record.shape[0])
    d = r.active_record[:n] != ref.active_record[:n]
    return dict(active_differ=int(d.sum()),
                first_step=int(np.argmax(d.any(1))) if d.any() else None,
                fractured=int((~r.active_record[-1]).sum()),
                fractured_ref=int((~ref.active_record[-1]).sum()))


def parting(coords, conn, cfg, model, recs) -> dict:
    """Why the two routes' fracture patterns part: the first step whose
    active masks differ and the elements that differ there; at that step
    (every earlier mask equal, so the stresses compare) each route's
    |stress| / max_stress of those elements (above 1 fractures) beside the
    converged one (float64 on the CPU, rtol 1e-12, cold, on the same mask),
    and each route's largest stress error over the active elements as a
    share of max_stress; the same ramp in float64 on the CPU (the port's
    plain path: the hybrid, dense tail included) at the configuration's
    rtol and at 1e-10, and each route's pattern against the latter; and
    both card routes again at rtol 1e-7."""
    from .fea.elements import element_strain
    from .fea.ramp import _step_factors
    a, b = recs["tree_cg"], recs["hybrid"]
    s = against(a, b)["first_step"]
    el = np.nonzero(a.active_record[s] != b.active_record[s])[0]
    cfg64 = dataclasses.replace(cfg, dtype="float64")
    m64 = build_model(coords, conn, cfg64, "cpu")
    mask = torch.as_tensor(a.active_record[s - 1] if s else
                           np.ones(m64.n_elems, bool))
    dy_top, dy_bot = _step_factors(cfg, s)
    res = solve_displacement(
        m64, mask, dy_top, dy_bot, torch.zeros((m64.n_nodes, 3),
                                               dtype=torch.float64),
        dataclasses.replace(cfg64, rtol=1e-12, warm_start=False),
        refresh_anchored(m64, mask))
    stress = np.where(mask.numpy(), cfg.e_mod * element_strain(
        res.x, m64.conn, m64.geom).numpy(), 0.0)
    out = dict(first_step=s, elements=el.tolist(),
               converged_solve=dict(iters=res.iters,
                                    converged=bool(res.converged)),
               stress_ratio_converged=(np.abs(stress[el])
                                       / cfg.max_stress).tolist())
    for name, r in (("tree_cg", a), ("hybrid", b)):
        out[f"stress_ratio_{name}"] = (
            np.abs(r.stress_record[s, el]) / cfg.max_stress).tolist()
        out[f"stress_error_{name}"] = float(
            np.abs(r.stress_record[s] - stress).max() / cfg.max_stress)
    ref = None
    for rtol in (cfg.rtol, 1e-10):
        t0 = time.perf_counter()
        ref = run_ramp(coords, conn, dataclasses.replace(cfg64, rtol=rtol),
                       model=m64)
        out[f"float64_rtol_{rtol:g}"] = dict(
            steps=int(ref.force_disp.shape[0]),
            fractured=int((~ref.active_record[-1]).sum()),
            iters=ref.cg_iters.tolist(), wall_s=time.perf_counter() - t0)
    out["tree_cg_vs_converged"] = against(a, ref)
    out["hybrid_vs_converged"] = against(b, ref)
    tight = {}
    out["rtol_1e-7"] = ramp_routes(
        coords, conn, dataclasses.replace(cfg, rtol=1e-7), model, tight)
    for name, r in tight.items():
        out["rtol_1e-7"][f"{name}_vs_converged"] = against(r, ref)
    return out


def grown_ramps(preset: str, seed=None, reps: int = 5) -> dict:
    """P6 on a grown network (``--grown``): the preset, or the
    configuration file, grown through ``run_growth`` on the card with
    ``seed``, its network built with ``hybrid_fea_config()`` or the file's
    ``fea``; cold solves on K6 and on the hybrid, and ``ramp_routes`` at
    the configuration's pull and, where nothing fractures there, at twice
    the displacement of the first fracture."""
    from .config import GROWTH_PRESETS, FeaConfig, GrowthConfig
    from .fea.elements import element_strain
    from .fea.model import TREE_KERNEL_MAX_BYTES
    from .fea.tree_factor import n_pcr_levels
    from .growth import run_growth, state_mesh
    if preset.endswith(".json"):
        with open(preset) as f:
            spec = json.load(f)
        gcfg, cfg = GrowthConfig(**spec["growth"]), FeaConfig(**spec["fea"])
    else:
        gcfg, cfg = GROWTH_PRESETS[preset], hybrid_fea_config()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    st, _, hist = run_growth(gcfg, seed=seed, device="cuda")
    t1 = time.perf_counter()
    coords, conn = state_mesh(st)
    t2 = time.perf_counter()
    model = build_model(coords, conn, cfg, "cuda")
    _sync()
    t3 = time.perf_counter()
    off = model.tree.meta.level_offsets
    out = dict(preset=preset, growth_seed=seed, steps=gcfg.t_steps,
               segments=hist[-1]["segments"], overflow=bool(st.overflow),
               nodes=model.n_nodes, elements=model.n_elems, dof=model.n_dof,
               level_slots=[b - a for a, b in zip(off, off[1:])],
               hybrid_pcr_levels=n_pcr_levels(model.tree.meta),
               tree_dense_tail=cfg.tree_dense_tail,
               tree_kernel=model.tree_kernel,
               kernel_bytes=tree_kernel_bytes(model),
               guard_bytes=TREE_KERNEL_MAX_BYTES,
               growth_s=t1 - t0, export_s=t2 - t1, build_s=t3 - t2,
               peak_bytes=torch.cuda.max_memory_allocated())
    del st
    active = torch.ones(model.n_elems, dtype=torch.bool, device="cuda")
    dy = cfg.displacement_max
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device="cuda")
    cold = dataclasses.replace(cfg, warm_start=False)
    anchored = refresh_anchored(model, active)
    out["cold_solve_ms"] = {
        name: solve_ms(lambda m=dataclasses.replace(model, tree_kernel=on):
                       solve_displacement(m, active, dy, -dy, x0, cold,
                                          anchored), reps)[0]
        for name, on in (("tree_cg", True), ("hybrid", False))}
    out["ramp"] = ramp_routes(coords, conn, cfg, model)
    if not any(r.get("fractured", 0) for r in out["ramp"].values()
               if isinstance(r, dict)):
        u = solve_displacement(model, active, dy, -dy, x0, cold,
                               anchored).x
        strain = float(element_strain(u, model.conn, model.geom).abs().max())
        first = dy * cfg.max_strain / max(strain, 1e-300)
        out.update(max_strain_at_pull=strain,
                   first_fracture_displacement=first)
        cfg2 = dataclasses.replace(cfg, displacement_max=2 * first)
        recs = {}
        twice = out["ramp_twice_first_fracture"] = ramp_routes(
            coords, conn, cfg2, model, recs)
        if twice.get("records", {}).get("active_differ"):
            out["parting"] = parting(coords, conn, cfg2, model, recs)
    return out


def profile_mesh(n_nodes: int, reps: int, out_dir, with_ramps: bool = False):
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
    k5_cfg = dataclasses.replace(cfg, precond="coarse", rtol=K5_RTOL,
                                 max_iter=K5_MAX_ITER)
    solves, cfgs = {}, {}
    for name, m, c in (
            ("tree_cg", dataclasses.replace(model, tree_kernel=True), cfg),
            ("hybrid", dataclasses.replace(model, tree_kernel=False), cfg),
            ("chain_cg", model, k5_cfg)):
        if solve_route(m, c) != name:
            raise AssertionError(f"{name}: the solve takes the route "
                                 f"{solve_route(m, c)}")

        def solve(m=m, c=c):
            return solve_displacement(m, active, dy, -dy, x0, c, anchored)

        solves[name], cfgs[name] = solve, (m, c)
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
    if with_ramps:
        out["ramp_routes"] = ramp_routes(coords, conn, ramp_cfg, model)
    yield None
    for name, solve in solves.items():
        n_syncs, sites = syncs_per_solve(solve, reps)
        trace = (os.path.join(out_dir, f"fea_{n_nodes}_{name}.json")
                 if out_dir else None)
        out["routes"][name].update(
            host_syncs_per_solve=n_syncs, syncs_by_line=sites,
            **profile(solve, reps, out["routes"][name]["solve_ms"], trace))
    m, c = cfgs["chain_cg"]
    caps = {}
    for cap in (0, 1, 10, None):
        cc = c if cap is None else dataclasses.replace(c, max_iter=cap)
        caps["converged" if cap is None else str(cap)] = kernel_ms(
            lambda: solve_displacement(m, active, dy, -dy, x0, cc, anchored),
            reps, "chain_cg")
    iters = out["routes"]["chain_cg"]["iters"]
    out["routes"]["chain_cg"].update(
        kernel_ms_by_cap=caps,
        kernel_us_per_iteration=(caps["converged"] - caps["10"]) * 1e3
        / max(iters - 10, 1))
    yield out


def sweep_mesh(n_nodes: int, trials: int, device="cuda") -> dict:
    """chip_smoke.py's sweep on ``synthetic_mesh(n_nodes)``: per
    combination the median ms over the loaded steps and the trials, the
    route, the iterations and the converged steps; the sweep's wall s."""
    from .bench import run_solver_sweep
    from .config import FeaConfig
    coords, conn = synthetic_mesh(n_nodes)
    cfg = FeaConfig(dtype="float32", rtol=K5_RTOL, max_iter=K5_MAX_ITER,
                    operator="chain", precond="tree", tree_coarse_weight=0.25,
                    tree_reg_rel=1e-7, n_steps=3)
    t0 = time.perf_counter()
    rows, meta = run_solver_sweep(coords, conn, cfg, trials=trials,
                                  return_meta=True, device=device)
    wall = time.perf_counter() - t0
    combos = {}
    for key, st in meta["combos"].items():
        ms = [r[4] for r in rows if f"{r[1]}+{r[2]}" == key and r[0] > 0]
        combos[key] = dict(median_ms=float(np.median(ms)),
                           route=st.get("route"),
                           median_iters=st["median_iters"],
                           converged_steps=st["converged_steps"])
    return dict(n_nodes=n_nodes, dof=3 * n_nodes, trials=trials,
                wall_s=wall, combos=combos)


def hybrid_apply(n_nodes: int, reps: int, device="cuda"):
    """The hybrid's tree preconditioner on ``synthetic_mesh(n_nodes)`` in
    chip_smoke.py's configuration (22k: ``hybrid_fea_config``; from 100k
    nodes ``bench.py``'s 309k one: grips 0.3 of the extent, coarse weight
    0.25), the system 5% fractured with its islands pinned: the
    factorization (``compute_tree_factor``, coarse weight 0) and one
    forest apply (``chain_preconditioner``'s tree PC, coarse weight 0) in
    call ms (CUDA events); whether two factorizations give the same dense
    tail inverse bit for bit; and the cold solve of the intact system on
    the hybrid route (the configuration's coarse weight), median wall ms
    of ``reps``. A generator, as ``profile_mesh``: the second step adds
    from ``torch.profiler`` the device operations and busy ms of an apply,
    of a factorization and of a solve, and the solve's host syncs. It uses
    nothing of the package beyond these calls' arguments, so the same file
    can time an older checkout."""
    from .fea.ramp import anchored_mask_host
    from .fea.solve import chain_preconditioner, compute_tree_factor
    coords, conn = synthetic_mesh(n_nodes)
    over = {}
    if n_nodes >= 100000:
        ext = float(coords[:, 1].max() - coords[:, 1].min())
        over = dict(grip_length=0.3 * ext, tree_coarse_weight=0.25)
    cfg = hybrid_fea_config(warm_start=False, **over)
    cfg0 = dataclasses.replace(cfg, tree_coarse_weight=0.0)
    model = dataclasses.replace(build_model(coords, conn, cfg, device),
                                tree_kernel=False)
    rng = np.random.default_rng(0)
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    act_np = rng.random(model.n_elems) >= 0.05
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), act_np,
                                              grip), device=device)
    act = torch.as_tensor(act_np, device=device)
    free = model.free_nodes & anch
    r = torch.as_tensor(rng.standard_normal((3, model.n_nodes)),
                        dtype=model.dtype, device=device)

    def factor():
        return compute_tree_factor(model, act, cfg0, anch)

    first = factor().sinv.clone()
    tail_same = bool(torch.equal(first, factor().sinv))
    pc = chain_preconditioner(model, act, cfg0, free, factor())
    intact = torch.ones(model.n_elems, dtype=torch.bool, device=device)
    anch_i = torch.as_tensor(anchored_mask_host(
        np.asarray(conn), np.ones(model.n_elems, bool), grip), device=device)
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=device)
    dy = cfg.displacement_max

    def solve():
        return solve_displacement(model, intact, dy, -dy, x0, cfg, anch_i)

    off = model.tree.meta.level_offsets
    out = dict(n_nodes=n_nodes, dof=model.n_dof,
               levels=[b - a for a, b in zip(off, off[1:])],
               pcr_levels=model.tree.meta.n_pcr,
               coarse_weight=cfg.tree_coarse_weight,
               dense_tail_inverse_same_bits_twice=tail_same,
               apply_ms=window_ms(lambda: pc(r), 100)[0],
               factor_ms=window_ms(factor, 10)[0])
    reset_launch_counts()
    pc(r)
    _sync()
    out["apply_launches"] = {k: v for k, v in launch_counts().items() if v}
    out["solve_ms"], res = solve_ms(solve, reps)
    out["solve_iters"] = res.iters
    yield out
    for name, fn, n in (("apply", lambda: pc(r), 20),
                        ("factor", factor, 5), ("solve", solve, reps)):
        prof = profile(fn, n, out[f"{name}_ms"], None)
        out[f"{name}_device_ops"] = prof["device_ops_per_solve"]
        out[f"{name}_device_busy_ms"] = prof["device_busy_ms"]
        out[f"{name}_top_kernels"] = prof["top_kernels_ms_per_solve"][:4]
    out["solve_host_syncs"], out["solve_sync_sites"] = syncs_per_solve(
        solve, reps)
    yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--nodes", type=int, nargs="+",
                    default=[7375, 33000, 103000])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    ap.add_argument("--ramp-routes", action="store_true",
                    help="also ramp on K6 and on the hybrid and compare")
    ap.add_argument("--sweep", type=int, default=0, metavar="TRIALS",
                    help="run only the solver sweep, TRIALS trials a mesh")
    ap.add_argument("--hybrid-apply", action="store_true",
                    help="only the hybrid's tree preconditioner: apply, "
                    "factorization, dense tail bits, cold solve")
    ap.add_argument("--grown", nargs="+", default=None, metavar="PRESET",
                    help="only P6: grow each preset or configuration file, "
                    "solve and ramp it on K6 and on the hybrid")
    ap.add_argument("--growth-seeds", type=int, nargs="+", default=[None],
                    help="the growth seeds of --grown")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_fea: needs a CUDA card")
    if args.grown:
        print(json.dumps(dict(card=card_line(), grown=[
            grown_ramps(p, seed, args.reps) for p in args.grown
            for seed in args.growth_seeds])))
        return 0
    if args.hybrid_apply:
        runs = [hybrid_apply(n, args.reps) for n in args.nodes]
        for run in runs:        # every wall reading before any trace
            next(run)
        print(json.dumps(dict(card=card_line(), reps=args.reps,
                              hybrid=[next(run) for run in runs])))
        return 0
    if args.sweep:
        print(json.dumps(dict(card=card_line(), sweeps=[
            sweep_mesh(n, args.sweep) for n in args.nodes])))
        return 0
    runs = [profile_mesh(n, args.reps, args.out, args.ramp_routes)
            for n in args.nodes]
    for run in runs:            # every wall reading before any trace
        next(run)
    print(json.dumps(dict(card=card_line(), reps=args.reps,
                          meshes=[next(run) for run in runs])))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
