"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``mycelium_tpu_torch``) through its main path, the FEA
pull test, and fails (non-zero exit) if any phase fails:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``mycelium_tpu_torch/kernels/csrc``;
3. compare each kernel with its plain PyTorch version on the card, at the
   shapes of the 22,125-DOF mesh's plan, and time both;
4. a cold solve at 22,125 DOF, checked in float64 on the host against the
   stiffness assembled with scipy from the element formula;
5. the full 40-step ramp at 22,125 DOF, its first 3 steps checked against
   the port's plain path on the CPU in float64;
6. a cold solve at 309k DOF with the same float64 check;
7. every kernel must have launched during phases 4-6.

The last lines are the card again, one JSON object with the kernels'
numbers, and ``{"ok": true, "device": {...}}``. Needs one CUDA card; with
none it exits non-zero and prints no result. No JAX is imported.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

RTOL = 1e-6            # the preset's CG tolerance
# float32 margin of the float64 residual check: CG measures the residual
# of the float32 operator (products and sums rounded at 6e-8 relative),
# whose distance from the float64 operator's residual grows with the
# stiffness spread of the mesh; 5e-5 of |b| bounds it with room
F32_MARGIN = 5e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def timed_ms(fn, device, reps: int) -> float:
    """Mean milliseconds per call, from CUDA events on the card."""
    import torch
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(a, b) -> tuple:
    """(max |a - b|, max |a - b| / max |b|) over all outputs."""
    a = [x.double() for x in a]
    b = [x.double() for x in b]
    err = max(float((x - y).abs().max()) if x.numel() else 0.0
              for x, y in zip(a, b))
    scale = max(float(y.abs().max()) if y.numel() else 0.0 for y in b)
    return err, err / max(scale, 1e-30)


def small_mesh(n_nodes: int):
    import bench
    if n_nodes == 7375 and os.path.isdir(bench.MESH_DIR):
        from mycelium_tpu.io import read_mesh_dir
        return read_mesh_dir(bench.MESH_DIR)
    return bench.synthetic_mesh(n_nodes)


def assemble_k(coords, conn, cfg, active):
    """float64 scipy stiffness of the active elements, from the element
    formula k_ax n n^T + k_bd (I - n n^T) in +/- block form."""
    import scipy.sparse as sp
    from mycelium_tpu_torch.fea.elements import element_geometry_host
    from mycelium_tpu_torch.fea.tree import element_k3
    n, _, k_ax, k_bd = element_geometry_host(coords, conn, cfg)
    k3 = element_k3(n, k_ax, k_bd)[active]
    c = conn[active].astype(np.int64)
    rows, cols, vals = [], [], []
    for a, b, sgn in ((0, 0, 1.0), (1, 1, 1.0), (0, 1, -1.0), (1, 0, -1.0)):
        r = 3 * c[:, a][:, None, None] + np.arange(3)[None, :, None]
        q = 3 * c[:, b][:, None, None] + np.arange(3)[None, None, :]
        rows.append(np.broadcast_to(r, k3.shape).ravel())
        cols.append(np.broadcast_to(q, k3.shape).ravel())
        vals.append(sgn * k3.ravel())
    nd = 3 * coords.shape[0]
    return sp.csr_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                 np.concatenate(cols))),
                         shape=(nd, nd))


def residual_check(model, coords, conn, cfg, x, dy, active_np, anchored_np):
    """Relative float64 residual of the free rows: |(K x)_f| / |(K u_k)_f|
    with x the returned displacement (prescribed values included)."""
    K = assemble_k(coords, np.asarray(conn), cfg, active_np)
    top = model.top_nodes.cpu().numpy()
    bot = model.bot_nodes.cpu().numpy()
    free = model.free_nodes.cpu().numpy() & anchored_np
    uk = np.zeros((coords.shape[0], 3))
    uk[top, 1] = dy
    uk[bot, 1] = -dy
    rows = np.repeat(free, 3)
    res = (K @ x.reshape(-1))[rows]
    b = (K @ uk.reshape(-1))[rows]
    return float(np.linalg.norm(res) / max(np.linalg.norm(b), 1e-300))


def compare_kernels(model, cfg, device, rng) -> list:
    """Phase 3: each kernel against its plain version at the plan's
    shapes, with a partly fractured active mask."""
    import torch
    from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
    from mycelium_tpu_torch.fea.tree_factor import (chain_tree_diag,
                                                    left_couplings)
    from mycelium_tpu_torch.kernels import (chain_matvec, chain_matvec_plain,
                                            pcr_apply, pcr_apply_plain,
                                            pcr_factor, pcr_factor_plain)
    plan, tree = model.chain, model.tree
    n = model.n_nodes
    active = torch.as_tensor(rng.random(model.n_elems) > 0.05, device=device)
    cab, jab = plan_active_masks_bool(plan, active)
    free_chain = model.free_nodes[plan.perm]
    f32 = model.dtype
    freem, cact, jact = (m.to(f32) for m in (free_chain, cab, jab))
    u = torch.as_tensor(rng.standard_normal((3, n)), dtype=f32,
                        device=device)
    rows = []

    # K1: float32 sums of the same terms; the plain version adds a node's
    # jump forces with index_add_ (atomics on the card, any order), the
    # kernel in CSR order, so they may differ by a few ulps of the largest
    # term: 1e-5 of max |K·u| bounds that for ~10-term sums
    errs, ms, pms = [], [], []
    for bc in (True, False):
        k = chain_matvec(plan, u, freem, cact, jact, cfg.reg, bc)
        p = chain_matvec_plain(plan, u, freem, cact, jact, cfg.reg, bc)
        err, rel = rel_err([k], [p])
        log(f"K1 chain_matvec bc={bc}: N={n} Jp={plan.ja.shape[0]} "
            f"max_abs_err={err:.3e} rel={rel:.3e} (tol 1e-5)")
        if not rel <= 1e-5:
            raise AssertionError(f"K1 bc={bc} disagrees: rel {rel:.3e}")
        errs.append(err)
        ms.append(timed_ms(lambda: chain_matvec(
            plan, u, freem, cact, jact, cfg.reg, bc), device, 200))
        pms.append(timed_ms(lambda: chain_matvec_plain(
            plan, u, freem, cact, jact, cfg.reg, bc), device, 200))
    rows.append(dict(name="chain_matvec", route="cuda",
                     source="mycelium_tpu_torch/kernels/csrc/chain_matvec.cu",
                     replaces="mycelium_tpu/fea/pallas_tree_big.py:55",
                     max_abs_err=max(errs), ms=ms[0], plain_ms=pms[0]))
    log(f"K1 time bc=True {ms[0]:.4f} ms (plain {pms[0]:.4f} ms), "
        f"bc=False {ms[1]:.4f} ms (plain {pms[1]:.4f} ms)")

    # K2/K3 on the largest PCR level, with the inputs the factorization
    # gives it (level 0 carries no Schur corrections or fill edges yet)
    meta = tree.meta
    sizes = [meta.level_offsets[i + 1] - meta.level_offsets[i]
             for i in range(len(meta.level_steps))]
    li = int(np.argmax(sizes))
    if li != 0 or model.tree_fast.meta.level_left_fill[0]:
        raise AssertionError("largest PCR level is not a fill-free level 0")
    S, steps = sizes[0], meta.level_steps[0]
    reg_pc = max(cfg.reg, cfg.tree_reg_rel * meta.k_scale)
    D = chain_tree_diag(tree, model.tree_fast, plan, active, free_chain,
                        reg_pc, cab, jab)[:, :S].contiguous()
    B = left_couplings(tree, model.tree_fast, active, free_chain,
                       model.n_elems, cab)[:, :S].contiguous()
    p0, p1 = meta.path_offsets[0], meta.path_offsets[1]
    fg = tree.first_gpos[p0:p1]
    lg = tree.last_gpos[p0:p1]
    kf = pcr_factor(D, B, fg, lg, steps)
    pf = pcr_factor_plain(D, B, fg, lg, steps)
    # K2: the same float32 operations in the same order (no FMA
    # contraction), but the adjugate inverses of reg-floored blocks of
    # fractured fragments amplify any rounding difference by up to
    # k_scale/reg_pc; 1e-4 of each output's largest entry bounds that
    err2, rel2 = 0.0, 0.0
    for name, a, b in zip(("alphas", "betas", "dinv", "corners"), kf, pf):
        e, r = rel_err([a], [b])
        log(f"K2 pcr_factor {name}: S={S} steps={steps} "
            f"max_abs_err={e:.3e} rel={r:.3e} (tol 1e-4)")
        err2, rel2 = max(err2, e), max(rel2, r)
    if not rel2 <= 1e-4:
        raise AssertionError(f"K2 disagrees: rel {rel2:.3e}")
    ms2 = timed_ms(lambda: pcr_factor(D, B, fg, lg, steps), device, 20)
    pms2 = timed_ms(lambda: pcr_factor_plain(D, B, fg, lg, steps), device, 5)
    rows.append(dict(name="pcr_factor", route="cuda",
                     source="mycelium_tpu_torch/kernels/csrc/pcr.cu",
                     replaces="mycelium_tpu/fea/pallas_factor.py:102",
                     max_abs_err=err2, ms=ms2, plain_ms=pms2))
    log(f"K2 time {ms2:.4f} ms (plain {pms2:.4f} ms)")

    # K3: same order of operations as the plain version; only the window
    # edges differ, and they never reach a central slot: 1e-5 relative
    al, be, dinv, _ = kf
    r = torch.as_tensor(rng.standard_normal((3, S)), dtype=f32,
                        device=device)
    k3 = pcr_apply(al, be, dinv, r)
    p3 = pcr_apply_plain(al, be, dinv, r)
    err3, rel3 = rel_err([k3], [p3])
    log(f"K3 pcr_apply: S={S} steps={steps} max_abs_err={err3:.3e} "
        f"rel={rel3:.3e} (tol 1e-5)")
    if not rel3 <= 1e-5:
        raise AssertionError(f"K3 disagrees: rel {rel3:.3e}")
    ms3 = timed_ms(lambda: pcr_apply(al, be, dinv, r), device, 200)
    pms3 = timed_ms(lambda: pcr_apply_plain(al, be, dinv, r), device, 50)
    rows.append(dict(name="pcr_apply", route="cuda",
                     source="mycelium_tpu_torch/kernels/csrc/pcr.cu",
                     replaces="mycelium_tpu/fea/pallas_factor.py:297",
                     max_abs_err=err3, ms=ms3, plain_ms=pms3))
    log(f"K3 time {ms3:.4f} ms (plain {pms3:.4f} ms)")
    return rows


def cold_solve(model, coords, conn, cfg, device, label: str, n_timed: int):
    """Phases 4 and 6: converged cold solve, float64 residual check,
    iterations and the median time of ``n_timed`` solves."""
    import torch
    from mycelium_tpu_torch.fea import solve_displacement
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    from mycelium_tpu_torch.fea.solve import STALL_ACCEPT
    off = model.tree.meta.level_offsets
    log(f"{label}: {model.n_dof} DOF, {model.n_elems} elements, "
        f"{model.chain.ja.shape[0]} padded jumps, tree levels of "
        f"{[b - a for a, b in zip(off, off[1:])]} slots, rounds "
        f"{model.tree.meta.level_steps}")
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    active_np = np.ones(model.n_elems, bool)
    anch_np = anchored_mask_host(np.asarray(conn), active_np, grip)
    active = torch.ones(model.n_elems, dtype=torch.bool, device=device)
    anchored = torch.as_tensor(anch_np, device=device)
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=device)
    dy = cfg.displacement_max

    def solve():
        return solve_displacement(model, active, dy, -dy, x0, cfg, anchored)

    res = solve()
    if not res.converged:
        raise AssertionError(f"{label}: cold solve did not converge "
                             f"(|r| {res.resnorm:.3e}, {res.iters} iters)")
    times = []
    for _ in range(n_timed):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            solve()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t = time.perf_counter()
            solve()
            times.append((time.perf_counter() - t) * 1e3)
    rel = residual_check(model, coords, conn, cfg,
                         res.x.double().cpu().numpy(), dy, active_np,
                         anch_np)
    bound = STALL_ACCEPT * RTOL + F32_MARGIN
    log(f"{label}: converged in {res.iters} iterations, |r|="
        f"{res.resnorm:.3e}; float64 relative residual of the free rows "
        f"{rel:.3e} (bound {bound:.1e}); median of {n_timed} solves "
        f"{float(np.median(times)):.3f} ms (min {min(times):.3f}, "
        f"max {max(times):.3f})")
    if not rel <= bound:
        raise AssertionError(f"{label}: float64 residual {rel:.3e} > "
                             f"{bound:.1e}")
    return float(np.median(times)), res.iters


def timed_build(coords, conn, cfg, device, label: str):
    from mycelium_tpu_torch.fea import build_model
    t0 = time.perf_counter()
    model = build_model(coords, conn, cfg, device)
    log(f"{label}: model build {time.perf_counter() - t0:.2f} s")
    return model


def ramp_check(coords, conn, cfg, model, device):
    """Phase 5: the 40-step ramp on the card; its first 3 steps against
    the plain path on the CPU in float64."""
    import dataclasses
    import torch
    from mycelium_tpu_torch.fea import build_model, run_ramp
    from mycelium_tpu_torch.fea.ramp import (_step_factors, anchored_mask_host,
                                             ramp_step)
    t0 = time.perf_counter()
    res = run_ramp(coords, conn, cfg, model=model)
    if device.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_rec = res.force_disp.shape[0]
    fractured = int((~res.active_record[-1]).sum())
    log(f"ramp: {n_rec} steps, {fractured} elements fractured, "
        f"{int(res.cg_iters.sum())} CG iterations, wall {wall:.3f} s "
        f"(solves {res.solve_seconds.sum():.3f} s)")

    # float64 reference on the host: the port's plain path, cold starts
    cfg64 = dataclasses.replace(cfg, dtype="float64", rtol=1e-10)
    m64 = build_model(coords, conn, cfg64, "cpu")
    grip = (m64.top_nodes | m64.bot_nodes).numpy()
    active = torch.ones(m64.n_elems, dtype=torch.bool)
    worst_u, worst_f = 0.0, 0.0
    for step in range(3):
        anch = torch.as_tensor(anchored_mask_host(
            np.asarray(conn), active.numpy(), grip))
        dt, db = _step_factors(cfg64, step)
        u, _, active_new, force, *_ = ramp_step(
            m64, cfg64, active, torch.zeros((m64.n_nodes, 3),
                                            dtype=torch.float64),
            dt, db, anch)
        u_ref = u.numpy().reshape(-1)
        du = np.linalg.norm(res.disp_record[step] - u_ref) / max(
            np.linalg.norm(u_ref), 1e-300)
        df = abs(res.force_disp[step, 1] - float(force)) / max(
            abs(float(force)), 1e-300)
        if step == 0:   # dy = 0: both are exactly zero
            du = float(np.abs(res.disp_record[0]).max())
            df = abs(float(res.force_disp[0, 1]))
        log(f"ramp step {step + 1}: displacement rel L2 {du:.3e}, force "
            f"rel {df:.3e} vs the float64 CPU path (tol 1e-3)")
        worst_u, worst_f = max(worst_u, du), max(worst_f, df)
        active = active_new
    # tolerance: the card runs float32 CG to rtol 1e-6 against a float64
    # solve to 1e-10; the error is the f32 residual floor times the
    # conditioning of the free block, measured well below 1e-3
    if not (worst_u <= 1e-3 and worst_f <= 1e-3):
        raise AssertionError(f"ramp disagrees with the float64 path: "
                             f"disp {worst_u:.3e}, force {worst_f:.3e}")
    return n_rec, fractured, wall


def run(device, n_small: int = 7375, n_big: int = 103000) -> dict:
    import torch

    import bench
    from mycelium_tpu_torch.config import hybrid_fea_config
    from mycelium_tpu_torch.kernels import build, launch_counts
    from mycelium_tpu_torch.kernels import reset_launch_counts

    device = torch.device(device)
    rng = np.random.default_rng(0)
    if device.type == "cuda":
        t0 = time.perf_counter()
        path, secs = build.build()
        build.library()
        log(f"kernels built in {secs:.2f} s ({time.perf_counter() - t0:.2f}"
            f" s with loading): {os.path.relpath(path, ROOT)}")

    coords, conn = small_mesh(n_small)
    cfg = hybrid_fea_config(warm_start=False)
    label = f"{3 * n_small} DOF"
    model = timed_build(coords, conn, cfg, device, label)
    rows = compare_kernels(model, cfg, device, rng)

    t0 = time.perf_counter()
    coords_b, conn_b = bench.synthetic_mesh(n_big)
    ext = float(coords_b[:, 1].max() - coords_b[:, 1].min())
    cfg_b = hybrid_fea_config(warm_start=False, grip_length=0.3 * ext)
    label_b = f"{3 * n_big} DOF"
    log(f"{label_b}: synthetic mesh {time.perf_counter() - t0:.2f} s")
    model_b = timed_build(coords_b, conn_b, cfg_b, device, label_b)

    reset_launch_counts()
    ms22, it22 = cold_solve(model, coords, conn, cfg, device,
                            f"cold solve {label}", 7)
    n_rec, fractured, ramp_s = ramp_check(
        coords, conn, hybrid_fea_config(), model, device)
    ms309, it309 = cold_solve(model_b, coords_b, conn_b, cfg_b, device,
                              f"cold solve {label_b}", 5)
    if device.type == "cuda":
        torch.cuda.synchronize()
    counts = launch_counts()
    log(f"kernel launches during the main path: {counts}")
    if device.type == "cuda":
        missing = [k for k, v in counts.items() if v < 1]
        if missing:
            raise AssertionError(f"kernels never launched: {missing}")
    for row in rows:
        row["launches"] = counts[row["name"]]
    return dict(kernels=rows, solve_ms_22k=ms22, iters_22k=it22,
                ramp_s_22k=ramp_s, ramp_steps_22k=n_rec,
                ramp_fractured_22k=fractured, solve_ms_309k=ms309,
                iters_309k=it309)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on a GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    import mycelium_tpu_torch  # noqa: F401  (fails outside a checkout)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    log(f"card: {card}")
    out = run("cuda")
    torch.cuda.synchronize()
    summary = {k: v for k, v in out.items() if k != "kernels"}
    log(f"summary: {json.dumps(summary)}")
    print(card)
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
