"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py

Drives the port (``mycelium_tpu_torch``) through its paths, the FEA pull
test, the solver sweep, growth with the coupled pipeline, checkpoints and
the sharded solve and ramp, and fails (non-zero exit) if any phase
fails:

1. print the card's name and power limit (nvidia-smi);
2. build the CUDA kernels from ``mycelium_tpu_torch/kernels/csrc``;
3. compare K1-K3 with their plain PyTorch versions on the card at the
   shapes of the 22,125-DOF mesh's plan and of the 309k-DOF mesh's (where
   the FEA path launches them), and time them, the plain versions and, for
   K1, one PyTorch sparse product: the call time ``ms`` (one event interval
   over back-to-back calls: the larger of the device's time and the host's
   time to submit a call) and ``device_ms``, the kernels' own duration
   from ``torch.profiler``; K1 through its bound operator, K2 through the
   model's bound launch (``PcrLaunch``: a level cut into
   path-aligned windows is one launch) held to its plain version on the
   CPU on copies of the same inputs (equal up to the sign of a zero), with
   the unbound global-rounds form timed beside it; K3 through the same
   launch (``PcrLaunch``: one launch a PCR level and sweep, the level's
   right-hand side and store fused in) on every PCR level of a
   factorization, forward, the dense tail's right-hand side and backward,
   twice, equal to its plain version on the CPU on copies of the same
   inputs, its level-0 launches and the whole forest apply timed, and the
   unbound halo form (K6's plain version's) within 1e-5 of plain and
   timed beside it;
4. compare K5 with its plain version on the CPU on copies of the same
   inputs, on the 22,125-DOF mesh 5% fractured: the set-up bit for bit
   (masks, start vector, block-Jacobi inverse, coarse matrix and inverse),
   x after 1 and 10 iterations (const and linear basis) and converged; two
   launches equal; its barriers by the rule; time both, with the latency
   floor (iterations x three barriers x the barrier's cost at K5's grid);
   Then fault P7's four sums (the chain diagonal's jump terms, the
   coarse matrix on the cluster layout of K5's sweep configuration, the
   hybrid's Schur corrections and forward right-hand sides), with every
   PCR level's K2 outputs through the bound launch, and the dense tail's
   matrix, on the same system: twice on the card, bit-equal to each other
   and to the CPU; the dense tail's inverse the same twice; and the
   fixed-order sum kernel against its plain version, timed on the coarse
   blocks (and, in phase 6, on the 309k system's short segments);
5. compare K6 with its plain version on the 22,125-DOF mesh, intact and 5%
   fractured with the islands pinned (the set-up phase's outputs against
   the plain set-up; one preconditioner apply on a random vector, the load
   case after 1 iteration and converged; two launches equal), print which
   levels run on path-aligned windows and the barriers of a solve, time
   both, count the device operations and host syncs of one K6 solve (at
   most 12 and 1), and time a grid-wide barrier at 33 to 264 blocks;
6. P7's check of phase 4 on the 309k-DOF system, whose hybrid factors 2
   PCR levels (K2 on a level with Schur corrections and fill edges, held
   to its plain version on the CPU); K6's comparison at the shapes of the
   larger meshes the main paths solve, 99k DOF (5 forest levels) and
   309k DOF (6 levels), where fills and attachments cross several
   levels; then K6 against the hybrid (K1-K3
   and a CG loop on the host) in one call: cold solves at 22,125, 99k and
   309k DOF, the same preconditioner on both sides, iterations and the
   float64 residual beside each time; this (and ``profile_fea.py`` on
   larger meshes) is what the memory guard ``TREE_KERNEL_MAX_BYTES`` rests
   on; and K5 as in phase 4 (the set-up bit for bit, x after 1 and 10
   iterations) at the shapes of the sweep path's 309k-DOF solve, on its
   own inputs: 403 clusters on fewer resident blocks, so a block loops
   over clusters, and the Gauss-Jordan inverse at nc 1,209;
6a. K7 (grip reachability) against ``anchored_mask_host`` (scipy) at
   22,125 and 309k DOF, element for element, on the intact mask, 10 drawn
   masks with 1-50% of the elements inactive and the top grip cut off;
   the kernel timed on a 5% fractured mask (call and device ms) beside
   its byte bound and the plain ``tree_anchored``'s time; its launches
   are read on the FEA path (the ramps' refreshes);
6b. K8 (a ramp step's post-solve and record rows) against
   ``post_solve_plain`` on CPU copies of the same inputs at 22,125 and
   309k DOF, bit for bit: stress, mask, disp, status and flag under a zero
   displacement and under drawn ones that fracture elements, on the
   intact mask, the top grip cut off and 5 masks with 1-50% of the
   elements inactive; ``fea.ramp.post_solve`` into one set of rows timed
   on a 5% fractured mask (call and device ms) beside K8's byte bound and
   the plain counterpart on the card; its launches are read on the FEA
   path (the ramps' post-solves) and must be there on the checkpoint,
   coupled, 3D pipeline, sharded and headline paths;
7. the FEA path, launch counts set to 0 before and read after: a cold
   solve at 22,125 DOF through K6, checked in float64 against the
   stiffness the port assembles (``fea/assemble.py::assemble_scipy``, on
   a float64 copy of the mesh: every residual check of the run, and K1's
   library product), the 40-step ramp (steps 1-3 against the
   port's plain path on the CPU in float64), ``run_ramp_async`` on the same
   model (records equal to ``run_ramp``'s), a cold solve at 309k DOF
   through K6 (the configuration's coarse weight 0.25 is not read there)
   and the same solve on the hybrid with that weight, as a model that
   cannot run K6 takes it: K1-K3's launches are read here, K2's one a
   PCR level a factorization; then one forest apply of that hybrid alone
   must make 2 K3 launches a PCR level and at most one ordered_sum (its
   device operations, and a factorization's, read in the traced tail);
   and one forest apply of the 22k hybrid (K2 and K3 through the model's
   ``PcrLaunch``) on the intact system, against the numpy oracle
   ``fea/tree.py::tree_apply_np`` in float64 on the host, within
   FOREST_F32_TOL (1e-3) of max |z|;
8. the sweep path, counts set to 0 before and read after: cg + coarse cold
   solves through K5 (median of 5 at 22,125 DOF with the float64 residual
   check, one at 309k DOF; in the traced tail, the device operations and
   host syncs of one such solve, at most 12 and 1, and two fresh model
   builds, equal iterations and x bit for bit), then the 15-combination
   solver x
   preconditioner sweep on the 22,125-DOF mesh, its cg + tree leg and
   physics solve through K6, its other tree legs through the hybrid
   (K1-K3);
9. the growth path, counts set to 0 before and read after: the xlarge
   preset (2^21 segment slots) for GROWTH_STEPS steps, K4 launched once
   per step;
10. K4 against its plain version on the grown xlarge state and on the
   tie-heavy states (``tests/torch_support.py::tie_state`` and, in 3D,
   ``tie_state_3d``: ties in different z cells and ranks of one column):
   bit-equal;
11. the demo preset grown twice with the same draws, through K4 and through
   the plain scan: equal states every 25 steps and at the end;
11a. 3D growth, counts set to 0 before and read after: the reference 3D
   configuration (``growth_3d_config``, gz 5) for its 25 steps and for 150
   steps at 2^16 / 2^15 slots, K4 once a step, no overflow; K4 against
   plain on the 150-step state, timed with its bound; the 150-step run
   and the 3D configuration at voxel 0.05 (gz 7, the 9-cell window) grown
   again through the plain scan: equal every 25 steps;
11b. the 9-cell window at full width, counts set to 0 before and read
   after: the xlarge preset at voxel 0.05 (g 704, 495,616 cells, a grid
   of 31.7 M entries) for GROWTH_STEPS steps, no overflow; K4 against
   plain on its state, timed with its bound;
11d. fault P11, counts set to 0 before and read after: K4 with more than
   32 tips in one cell of the tip table (``tests/torch_support.py::
   many_tips_case``: every hypha from one inoculum point,
   max_tips_per_cell 64), the 2D corner form and the 3D column form, each
   grown through K4 and through the plain scan, equal every step; K4
   against plain on each last state, bit for bit, timed with its bound;
11c. the 3D pipeline, counts set to 0 before and read after: the 150-step
   3D network exported, read back, a cold solve (float64 residual check)
   and the 40-step pull test on its route (K6), every step converged,
   the records written;
12. the coupled pipeline at the medium preset with the fast solver preset,
   counts set to 0 before and read after: grow -> mesh -> model on the
   card -> cold solve (float64 residual check) -> 40-step ramp, the
   solves through K6 where the model can run it;
13. checkpoints, counts set to 0 before and read after (K6 and K4 must
   launch): the 22k ramp of phase 7 stopped after 20 steps with
   ``checkpoint_every=20`` and resumed from the file, every record bit
   for bit the unsplit run's; the same ramp run on the CPU in float32,
   stopped after 20 steps and resumed on the card, within 1e-3 of the
   card's run at every step; the file's size, save and load times; the
   demo growth split at step 75 and resumed, every field bit for bit;
14. the sharded path over a one-rank NCCL group (a ``file://`` store):
   the single-device references first, then, counts set to 0, the
   sharded tree solve at 22,125 and 309k DOF (K2, K3, ``ordered_sum``)
   against the hybrid (1e-3 of max |x|, iterations within ±1, the
   float64 residual), the sharded coarse solve at 22,125 DOF against K5
   (iterations within 2%), each timed with its element operator alone,
   and the 40-step sharded ramp at 309k DOF against ``run_ramp`` on the
   hybrid (equal active records, forces within 1e-3); K2, K3 and
   ``ordered_sum`` must launch; the card has one GPU, so no multi-GPU
   number is taken;
14a. growth over the same one-rank group (``growth/shard.py``), counts set
   to 0 before and read after: the demo preset for 20 steps with the
   segment slots split over the ranks, every field, the grid and the
   stats bit for bit ``run_growth``'s on one device, K4 once a step;
16. the scaling path, counts set to 0 before and read after:
   ``bench/scaling.py`` at the five sizes of the reference's scaling
   artifact, 7,375 to 1,000,000 nodes (22,125 to 3,000,000 DOF), full
   width: each size's row and route, K6 launched on the route
   ``tree_cg`` (K1-K3 on the hybrid), the last solve's float64 residual
   by the port's ``fea/assemble.py::assemble_scipy`` within K6_LIMIT
   (STALL_LIMIT on the hybrid), ``bytes_total`` positive and finite,
   ``cg_iters`` at least 1; the mesh generation and plan build times of
   each size and the phase's wall time;
17. the headline, counts set to 0 before and read after:
   ``bench/headline.py::run`` at its defaults, the port of the root
   ``bench.py``: the 22,125-DOF cold-solve median (16 solves a window, 5
   windows), the 309k-DOF cold solve (``scaling_size``) and the 309k-DOF
   40-step ``run_ramp_async`` (one untimed, the median of 3), its JSON
   line printed before the kernels' line; both solves and the ramp on the
   route ``tree_cg``, K6's launches equal to what the loops imply, the
   22k solve's float64 residual within K6_LIMIT, every ramp step
   converged and 1 to 40 steps recorded, every number finite and
   positive; then where the ramp's time goes (solves, ``post_solve``,
   reachability refreshes, the rest);
15. every reading that traces the card (each kernel's ``device_ms``, K5's
   and K6's time by iteration cap, the device operations and host syncs of
   a K5, a K6 and each sharded solve, the NCCL kernels' device time, K5's
   fresh builds), last: a ``torch.profiler``
   window slows every later launch of the process on the host, so it may
   not precede a phase that is timed on the host's clock.

The last lines are the card again, one JSON object with the kernels'
numbers, and ``{"ok": true, "device": {...}}``. Needs one CUDA card; with
none it exits non-zero and prints no result. No JAX is imported.

Time: the whole run must end within 1200 s, the kernels' build included;
phases 4 and 8 (K5 and the sweep) have a budget of 90 s of it. On an
H100 the run took 181-189 s with phases 11a-11d and 14a, 183-209 s with
phase 16 (22-46 s of it, 11 s the 1M-node mesh's generation on the host)
and 249 s with phase 17 (2.5 s of it).
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

RTOL = 1e-6            # the preset's CG tolerance
# the sweep's solver settings (scripts/bench_sweep_tpu.py): PETSc's default
# rtol, which the reference's sweep ran, and a cap for the weak legs
SWEEP_RTOL = 1e-5
SWEEP_MAX_ITER = 3000
SWEEP_STEPS = 3
# float32 margin of the float64 residual check: CG measures the residual
# of the float32 operator (products and sums rounded at 6e-8 relative),
# whose distance from the float64 operator's residual grows with the
# stiffness spread of the mesh; 5e-5 of |b| bounds it with room
F32_MARGIN = 5e-5
# the float64 residual bound of a tree-PC solve, which may stop on a
# plateau within 10 (STALL_ACCEPT) times its tolerance
STALL_LIMIT = 10.0 * RTOL + F32_MARGIN
# K5 stops only on its tolerance (no stall exit); K6's solves here stop on
# theirs too, well before its stall exit could fire
K5_LIMIT = SWEEP_RTOL + F32_MARGIN
K6_LIMIT = RTOL + F32_MARGIN
# the float32 tolerance of the hybrid's forest apply (K2 factoring, K3
# applying) against the float64 numpy oracle on the intact 22k system,
# relative to max |z|: the float32 factorization of the forest's paths at
# reg 1e-7 k_scale; the plain version on a CPU reads 1.18e-4
FOREST_F32_TOL = 1e-3
GROWTH_STEPS = 150     # xlarge steps (the preset's full run)
# phase 16: the sizes of the reference's scaling artifact
# (scripts/bench_scaling_r05.py), 22,125 to 3,000,000 DOF
SCALING_NODES = (7375, 33000, 103000, 340000, 1000000)
HBM_BYTES_PER_S = 3.35e12    # H100 SXM device memory
F32_OPS_PER_S = 67e12        # H100 SXM float32 outside the tensor cores


def log(msg: str) -> None:
    print(msg, flush=True)


def shared_checks():
    """``tests/torch_support.py``: the tie-heavy scan state and the
    fixed-order sums, which this script and the tests hold to the same
    checks."""
    import torch
    tests = os.path.join(ROOT, "tests")
    if tests not in sys.path:
        sys.path.insert(0, tests)
    threads = torch.get_num_threads()
    import torch_support      # sets one thread, for the tests' workers
    torch.set_num_threads(threads)
    return torch_support


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def sync(device) -> None:
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize()


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


def device_ms(fn, device, reps: int) -> float:
    """Mean milliseconds of device time per call: the durations of the
    kernels (and copies) that ``reps`` calls put on the card, summed from a
    ``torch.profiler`` trace. What the card spends, whatever the host needs
    to submit the call."""
    import torch
    if device.type != "cuda":
        return timed_ms(fn, device, reps)
    from torch.profiler import ProfilerActivity, profile

    from mycelium_tpu_torch.utils.profiling import device_ops
    fn()
    torch.cuda.synchronize()
    # a window now and then comes back empty (seen once in four runs on
    # the card, on a K5 launch the window before had timed): trace again
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        total = sum(e.device_time for e in device_ops(prof))
        if total > 0:
            return total / 1e3 / reps
        log("the profiler saw no device time in a window: tracing again")
    raise AssertionError("the profiler saw no device time")


# Work that traces the card, run at the end of the run. Found on the card:
# after a torch.profiler window every later launch of the process costs the
# host more (the xlarge growth ran 48-58 steps/s after one and 85-91
# without, the sweep's host-loop legs 30-50% slower), so no traced window
# may precede a phase that is timed on the host's clock.
_DEFERRED = []


def defer(action) -> None:
    _DEFERRED.append(action)


def defer_device_ms(label: str, row: dict, fn, reps: int, key="device_ms",
                    call_key="ms") -> None:
    """Leave ``row[key]`` to be read at the end of the run as the device
    time of ``fn``; ``row[call_key]`` is its call time, already read."""
    row[key] = None

    def read(device):
        row[key] = device_ms(fn, device, reps)
        call = row[call_key]
        log(f"{label}: call {call:.4f} ms, device {row[key]:.4f} ms (host "
            f"share {host_share(call, row[key]):.0%}, "
            f"{(call - row[key]) * 1e3:.1f} us)")

    defer(read)


def run_deferred(device) -> None:
    while _DEFERRED:
        _DEFERRED.pop(0)(device)


def host_share(ms: float, dev: float) -> float:
    """The share of a call's time that is not the device's."""
    return max(0.0, 1.0 - dev / ms) if ms > 0 else 0.0


def bound(nbytes: float, ops: float) -> tuple:
    """(least ms, 'bytes' or 'operations'): the larger of the bytes over
    the memory rate and the float32 operations over the peak rate."""
    tb, to = nbytes / HBM_BYTES_PER_S * 1e3, ops / F32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def nbytes(*ts) -> int:
    return int(sum(t.numel() * t.element_size() for t in ts))


def rel_err(a, b) -> tuple:
    """(max |a - b|, max |a - b| / max |b|) over all outputs."""
    a = [x.double() for x in a]
    b = [x.double() for x in b]
    err = max(float((x - y).abs().max()) if x.numel() else 0.0
              for x, y in zip(a, b))
    scale = max(float(y.abs().max()) if y.numel() else 0.0 for y in b)
    return err, err / max(scale, 1e-30)


def residual_check(model, coords, conn, cfg, x, dy, active_np, anchored_np):
    """Relative float64 residual of the free rows: |(K x)_f| / |(K u_k)_f|
    with x the returned displacement (prescribed values included)."""
    from mycelium_tpu_torch.fea.assemble import (assemble_scipy,
                                                 host_model_f64)
    K = assemble_scipy(host_model_f64(model, coords, conn, cfg), active_np)
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


def sparse_bc_operator(model, coords, conn, cfg, active_np, freem, device):
    """The BC'd operator of K1 as one torch sparse CSR matrix on the card,
    in K1's layout (plane c*N + p, p a chain position), assembled once:
    F K F + reg F + (I - F) with F the free mask."""
    import scipy.sparse as sp
    import torch
    from mycelium_tpu_torch.fea.assemble import (assemble_scipy,
                                                 host_model_f64)
    n = model.n_nodes
    perm = model.chain.perm.cpu().numpy()
    dof = (3 * perm[None, :] + np.arange(3)[:, None]).reshape(-1)
    K = assemble_scipy(host_model_f64(model, coords, conn, cfg),
                       active_np)[dof][:, dof]
    f = np.tile(freem.cpu().numpy().astype(np.float64), 3)
    Kbc = (sp.diags(f) @ K @ sp.diags(f)
           + sp.diags(cfg.reg * f + (1.0 - f))).tocsr()
    Kbc.sort_indices()
    return torch.sparse_csr_tensor(
        torch.as_tensor(Kbc.indptr, dtype=torch.int64),
        torch.as_tensor(Kbc.indices, dtype=torch.int64),
        torch.as_tensor(Kbc.data, dtype=torch.float32),
        size=(3 * n, 3 * n)).to(device)


def compare_kernels(model, coords, conn, cfg, device, rng, size: str) -> list:
    """Phase 3: K1-K3 against their plain versions at the plan's shapes
    (``size`` names the mesh), with a partly fractured active mask. Each
    time twice: per call and on the device."""
    import torch
    from mycelium_tpu_torch.fea.chain import plan_active_masks_bool
    from mycelium_tpu_torch.fea.tree_factor import (chain_tree_diag,
                                                    left_couplings)
    from mycelium_tpu_torch.kernels import (ChainOperator, chain_matvec,
                                            chain_matvec_plain, pcr_apply,
                                            pcr_apply_plain, pcr_factor,
                                            pcr_factor_plain)
    plan, tree = model.chain, model.tree
    n = model.n_nodes
    active_np = rng.random(model.n_elems) > 0.05
    active = torch.as_tensor(active_np, device=device)
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
    # term: 1e-5 of max |K·u| bounds that for ~10-term sums. Against the
    # plain version on the CPU, which adds in the kernel's order: 0
    op = ChainOperator(plan, freem, cact, jact, cfg.reg)
    cpu = [t.cpu() for t in (u, freem, cact, jact)]
    from mycelium_tpu_torch.devices import moved
    plan_c = moved(plan, "cpu")
    errs, ms, pms = [], [], []
    for bc in (True, False):
        k = op.apply(u, bc)
        p = chain_matvec_plain(plan, u, freem, cact, jact, cfg.reg, bc)
        pc = chain_matvec_plain(plan_c, *cpu, cfg.reg, bc)
        err, rel = rel_err([k], [p])
        same = torch.equal(k.cpu(), pc) and torch.equal(
            chain_matvec(plan, u, freem, cact, jact, cfg.reg, bc), k)
        log(f"K1 chain_matvec {size} bc={bc}: N={n} Jp={plan.ja.shape[0]} "
            f"max_abs_err={err:.3e} rel={rel:.3e} (tol 1e-5); bit-equal to "
            f"plain on the CPU and to the one-shot form: {same}")
        if not (rel <= 1e-5 and same):
            raise AssertionError(f"K1 {size} bc={bc} disagrees: rel "
                                 f"{rel:.3e}, bit-equal on the CPU {same}")
        errs.append(err)
        ms.append(timed_ms(lambda: op.apply(u, bc), device, 200))
        pms.append(timed_ms(lambda: chain_matvec_plain(
            plan, u, freem, cact, jact, cfg.reg, bc), device, 200))
    one_shot = timed_ms(lambda: chain_matvec(plan, u, freem, cact, jact,
                                             cfg.reg, True), device, 200)
    Kt = sparse_bc_operator(model, coords, conn, cfg, active_np, freem,
                            device)
    uf = u.reshape(-1)
    lib_ms = timed_ms(lambda: Kt @ uf, device, 200)
    _, lib_rel = rel_err([(Kt @ uf).reshape(3, n)], [op.apply(u, True)])
    jp, nj = plan.ja.shape[0], plan.jump_ent.shape[0]
    k32 = plan.k32
    b1 = bound(nbytes(u, freem, cact, jact, k32.chain_pack, plan.chain_kbd,
                      k32.jump_pack, plan.jump_kbd, k32.ja, k32.jb,
                      k32.jump_ptr, k32.jump_ent) + 3 * n * 4,
               n * 45 + nj * 40)
    rows.append(dict(name="chain_matvec", route="cuda",
                     source="mycelium_tpu_torch/kernels/csrc/chain_matvec.cu",
                     replaces="mycelium_tpu/fea/pallas_tree_big.py:55",
                     max_abs_err=max(errs), ms=ms[0], plain_ms=pms[0],
                     bound_ms=b1[0], bound_by=b1[1], library_ms=lib_ms,
                     one_shot_ms=one_shot, raw_ms=ms[1]))
    defer_device_ms(f"K1 {size} bc=True", rows[-1],
                    lambda: op.apply(u, True), 200)
    defer_device_ms(f"K1 {size} bc=False", rows[-1],
                    lambda: op.apply(u, False), 200, "raw_device_ms",
                    "raw_ms")
    defer_device_ms(f"sparse CSR product {size}", rows[-1], lambda: Kt @ uf,
                    200, "library_device_ms", "library_ms")
    log(f"K1 time {size} bc=True call {ms[0]:.4f} ms (one-shot form "
        f"{one_shot:.4f} ms; plain {pms[0]:.4f} ms; sparse CSR product call "
        f"{lib_ms:.4f} ms, rel {lib_rel:.1e} from K1; bound {b1[0]:.5f} ms "
        f"by {b1[1]}), bc=False call {ms[1]:.4f} ms (plain {pms[1]:.4f} "
        f"ms); {jp} padded jumps")

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
    # K2 through the model's bound launch (the level cut into path-aligned
    # windows, one launch) against its plain version on the CPU on copies
    # of the same inputs: the same float32 operations in the same order
    # (no FMA contraction), windows that need nothing outside them: 0,
    # only the sign of a zero may differ (torch.equal)
    launch = model.pcr_launch
    if not launch.windowed[0]:
        raise AssertionError(f"K2 {size}: level 0 is not windowed")
    kf = [t.clone() for t in launch.factor(0, D, B)]
    pf = launch.plain(0, D.cpu(), B.cpu())
    err2 = max(float((a.cpu().double() - b.double()).abs().max())
               for a, b in zip(kf, pf))
    same2 = all(torch.equal(a.cpu(), b) for a, b in zip(kf, pf))
    n_glob = sum(not w for w in launch.windowed)
    log(f"K2 pcr_factor {size}: S={S} steps={steps}, "
        f"{launch.windows[0][2]} windows; max_abs_err={err2:.3e} against "
        f"the plain version on the CPU, equal: {same2}; PCR levels "
        f"{len(launch.windowed)}, on global rounds {n_glob}")
    if not same2:
        raise AssertionError(f"K2 {size} disagrees with its plain version "
                             f"on the CPU: {err2:.3e}")
    ms2 = timed_ms(lambda: launch.factor(0, D, B), device, 50)
    glob_ms = timed_ms(lambda: pcr_factor(D, B, fg, lg, steps), device, 20)
    pms2 = timed_ms(lambda: pcr_factor_plain(D, B, fg, lg, steps), device, 5)
    # per slot and round: an adjugate inverse (~41 ops), six 3x3 block
    # products (270), the block updates (36), and the six corner columns'
    # two block-vector products each (216); a last inverse and apply (131)
    b2 = bound(nbytes(D, B, fg, lg, *kf), S * (steps * 563 + 131))
    rows.append(dict(name="pcr_factor", route="cuda",
                     source="mycelium_tpu_torch/kernels/csrc/pcr.cu",
                     replaces="mycelium_tpu/fea/pallas_factor.py:102",
                     max_abs_err=err2, ms=ms2, plain_ms=pms2,
                     bound_ms=b2[0], bound_by=b2[1], library_ms=None,
                     global_rounds_ms=glob_ms,
                     global_levels=n_glob))
    defer_device_ms(f"K2 {size}", rows[-1],
                    lambda: launch.factor(0, D, B), 50)
    defer_device_ms(f"K2 {size}, unbound on global rounds", rows[-1],
                    lambda: pcr_factor(D, B, fg, lg, steps), 20,
                    "global_rounds_device_ms", "global_rounds_ms")
    log(f"K2 time {size} call {ms2:.4f} ms (unbound, global rounds "
        f"{glob_ms:.4f} ms; plain {pms2:.4f} ms, bound {b2[0]:.5f} ms by "
        f"{b2[1]})")

    # K3 bound (the hybrid's sweep, one launch a level and sweep on the
    # path-aligned windows) on every PCR level of a factorization, forward
    # and backward, against its plain version on the CPU on copies of the
    # same inputs, twice: the same float32 operations in the same order,
    # windows that need nothing outside them: 0 (torch.equal)
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    from mycelium_tpu_torch.fea.solve import compute_tree_factor
    support = shared_checks()
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), active_np,
                                              grip), device=device)
    factor = compute_tree_factor(model, active, cfg, anch)   # islands pinned
    # its own generator: the later phases draw what they drew before
    rp = torch.as_tensor(np.random.default_rng(8).standard_normal((3, n)),
                         dtype=f32, device=device)
    err3 = 0.0
    for run_ in range(2):
        pairs = support.bound_sweep_pairs(tree, launch, factor, rp)
        sync(device)
        bad = [k for k, (a, b) in pairs.items()
               if not torch.equal(a.cpu(), b)]
        err3 = max([err3] + [float((a.cpu().double() - b.double()).abs()
                                   .max()) if b.numel() else 0.0
                             for a, b in pairs.values()])
        log(f"K3 bound sweep {size}, run {run_ + 1}: {len(launch.sizes)} "
            f"PCR levels ({[w[2] for w in launch.windows]} windows), "
            f"forward, the tail's right-hand side and backward against "
            f"the plain version on the CPU: max_abs_err={err3:.3e}, equal: "
            f"{not bad}")
        if bad:
            raise AssertionError(f"K3 {size}: the bound sweep disagrees "
                                 f"with its plain version on the CPU: {bad}")
    # the unbound form (a level's rounds alone, halo windows), K6's plain
    # version's, against its plain version on the card: the same order of
    # operations, the window edges never reach a central slot: 1e-5
    al, be, dinv, _ = kf
    r = torch.as_tensor(rng.standard_normal((3, S)), dtype=f32,
                        device=device)
    k3 = pcr_apply(al, be, dinv, r)
    p3 = pcr_apply_plain(al, be, dinv, r)
    herr, hrel = rel_err([k3], [p3])
    log(f"K3 unbound halo form {size}: S={S} steps={steps} "
        f"max_abs_err={herr:.3e} rel={hrel:.3e} (tol 1e-5)")
    if not hrel <= 1e-5:
        raise AssertionError(f"K3 halo form {size} disagrees: rel "
                             f"{hrel:.3e}")
    # level 0's launches alone, into one forward result (K1's u above is
    # read again in the traced tail: not these); the launch takes CUDA
    # tensors only, so a rehearsal on the CPU times the emulation
    if device.type == "cuda":
        u3, nv3 = launch.forward(factor, rp)

        def fwd0():
            launch.sweep_level(0, False, factor, rp, u3, nv3)

        def bwd0():
            launch.sweep_level(0, True, factor, u3, u3, u3)

        def apply():
            return launch.apply(factor, rp)
    else:
        def fwd0():
            return support.emulate_pcr_sweep(launch, factor, rp)

        bwd0 = apply = fwd0
    ms3 = timed_ms(fwd0, device, 200)
    bms3 = timed_ms(bwd0, device, 200)
    apply_ms = timed_ms(apply, device, 100)
    halo_ms = timed_ms(lambda: pcr_apply(al, be, dinv, r), device, 200)
    pms3 = timed_ms(lambda: pcr_apply_plain(al, be, dinv, r), device, 50)
    # the rounds alone (the first cut's bound, kept so the row compares):
    # the coefficients, dinv, r in and u out; per slot and round two 3x3
    # block-vector products (36), a last one (15)
    b3 = bound(nbytes(al, be, dinv, r, k3), S * (steps * 36 + 15))
    # the fused forward level: the same plus the CSR pointers, the path
    # ends by slot, the windows, and at each path end its coupling read
    # and its product written (level 0 has no incoming attachments)
    P0 = meta.path_offsets[1] - meta.path_offsets[0]
    n_win = launch.windows[0][2]
    sb3 = bound(nbytes(al, be, dinv, r, k3) + S * (4 + 8) + n_win * 8
                + 2 * P0 * (36 + 12), S * (steps * 36 + 15) + 2 * P0 * 15)
    rows.append(dict(name="pcr_apply", route="cuda",
                     source="mycelium_tpu_torch/kernels/csrc/pcr.cu",
                     replaces="mycelium_tpu/fea/pallas_factor.py:297",
                     max_abs_err=err3, ms=ms3, plain_ms=pms3,
                     bound_ms=b3[0], bound_by=b3[1], library_ms=None,
                     sweep_bound_ms=sb3[0], backward_ms=bms3,
                     apply_ms=apply_ms, halo_form_ms=halo_ms,
                     halo_form_rel=hrel))
    defer_device_ms(f"K3 {size} forward level 0", rows[-1], fwd0, 200)
    defer_device_ms(f"K3 {size} backward level 0", rows[-1], bwd0, 200,
                    "backward_device_ms", "backward_ms")
    defer_device_ms(f"hybrid tree apply {size}", rows[-1], apply, 100,
                    "apply_device_ms", "apply_ms")
    defer_device_ms(f"K3 {size}, unbound halo form", rows[-1],
                    lambda: pcr_apply(al, be, dinv, r), 200,
                    "halo_form_device_ms", "halo_form_ms")
    log(f"K3 time {size} forward level 0 call {ms3:.4f} ms, backward "
        f"{bms3:.4f} ms, the whole tree apply {apply_ms:.4f} ms (unbound "
        f"halo form {halo_ms:.4f} ms; plain rounds {pms3:.4f} ms; bound of "
        f"the rounds {b3[0]:.6f} ms by {b3[1]}, of the fused level "
        f"{sb3[0]:.6f} ms by {sb3[1]})")
    return rows


def cold_solve(model, coords, conn, cfg, device, label: str, n_timed: int,
               limit: float = STALL_LIMIT, route=None):
    """A cold solve that must converge, with the float64 residual check;
    returns the median time of ``n_timed`` solves and the iterations.
    ``route`` replaces ``solve_displacement`` (same arguments)."""
    import torch
    from mycelium_tpu_torch.fea import solve_displacement
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
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
        return (route or solve_displacement)(model, active, dy, -dy, x0, cfg,
                                             anchored)

    res = solve()
    if not res.converged:
        raise AssertionError(f"{label}: cold solve did not converge "
                             f"(|r| {res.resnorm:.3e}, {res.iters} iters)")
    if not np.isfinite(res.x.cpu().numpy()).all():
        raise AssertionError(f"{label}: non-finite displacement")
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
    log(f"{label}: converged {res.converged} in {res.iters} iterations, "
        f"|r|={res.resnorm:.3e}; float64 relative residual of the free rows "
        f"{rel:.3e} (bound {limit:.1e}); median of {n_timed} solves "
        f"{float(np.median(times)):.3f} ms (min {min(times):.3f}, "
        f"max {max(times):.3f})")
    if not rel <= limit:
        raise AssertionError(f"{label}: float64 residual {rel:.3e} > "
                             f"{limit:.1e}")
    return float(np.median(times)), res.iters


def timed_build(coords, conn, cfg, device, label: str):
    from mycelium_tpu_torch.fea import build_model
    t0 = time.perf_counter()
    model = build_model(coords, conn, cfg, device)
    log(f"{label}: model build {time.perf_counter() - t0:.2f} s")
    return model


def ramp_check(coords, conn, cfg, model, device):
    """The 40-step ramp on the card; its first 3 steps against the plain
    path on the CPU in float64."""
    import torch
    from mycelium_tpu_torch.fea import build_model, run_ramp
    from mycelium_tpu_torch.fea.ramp import (_step_factors, anchored_mask_host,
                                             ramp_step)
    t0 = time.perf_counter()
    res = run_ramp(coords, conn, cfg, model=model)
    sync(device)
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
    return n_rec, fractured, wall, res


def async_check(coords, conn, cfg, model, device, loop, loop_wall) -> float:
    """``run_ramp_async`` on the same model: the records of ``run_ramp``.
    The kernel adds in a fixed order, its set-up included (no float
    atomics), so the two runs solve the same systems; the reachability
    sweep and the reactions are PyTorch operations. The active masks and
    the iteration counts must be equal, displacement (per-step L2) and
    force within 1e-4 of the ramp's largest (the reading is printed)."""
    from mycelium_tpu_torch.fea import run_ramp_async
    t0 = time.perf_counter()
    res = run_ramp_async(coords, conn, cfg, model=model, sync_every=8)
    sync(device)
    wall = time.perf_counter() - t0
    same_shape = res.disp_record.shape == loop.disp_record.shape
    same_active = same_shape and np.array_equal(res.active_record,
                                                loop.active_record)
    du = df = float("inf")
    if same_shape:
        scale = max(np.linalg.norm(loop.disp_record, axis=1).max(), 1e-300)
        du = float(np.linalg.norm(res.disp_record - loop.disp_record,
                                  axis=1).max() / scale)
        fs = max(np.abs(loop.force_disp[:, 1]).max(), 1e-300)
        df = float(np.abs(res.force_disp[:, 1]
                          - loop.force_disp[:, 1]).max() / fs)
    log(f"run_ramp_async: {res.force_disp.shape[0]} steps, wall {wall:.3f} s "
        f"(run_ramp {loop_wall:.3f} s); active masks equal {same_active}, "
        f"displacement rel L2 {du:.3e}, force rel {df:.3e} (tol 1e-4), "
        f"{int(res.cg_iters.sum())} CG iterations "
        f"(run_ramp {int(loop.cg_iters.sum())})")
    if not (same_active and du <= 1e-4 and df <= 1e-4):
        raise AssertionError("run_ramp_async disagrees with run_ramp")
    return wall


def grow_run(label: str, cfg, device):
    """Growth at one configuration on ``device``: K4 must launch once per
    step; no capacity may overflow. Returns (final state, readings)."""
    import torch
    from mycelium_tpu_torch.growth import run_growth
    from mycelium_tpu_torch.growth.neighbors import check_layout
    from mycelium_tpu_torch.growth.step import StepSyncs
    from mycelium_tpu_torch.kernels import launch_counts
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    syncs = StepSyncs()
    before = launch_counts()["anast_scan"]
    t0 = time.perf_counter()
    st, _, hist = run_growth(cfg, device=device, syncs=syncs)
    sync(device)
    wall = time.perf_counter() - t0
    launches = launch_counts()["anast_scan"] - before
    mem = torch.cuda.max_memory_allocated() if device.type == "cuda" else 0
    final = hist[-1]
    steps = cfg.t_steps
    layout = check_layout(cfg)
    log(f"{label}: {steps} steps in {wall:.3f} s "
        f"({steps / wall:.3f} steps/s, init included), layout {layout}, "
        f"{cfg.max_segments} slots, {final['segments']} segments, "
        f"{final['hyphae']} hyphae, {final['anastomosed']} anastomosed, "
        f"total length {final['total_length_mm']:.3f} mm, overflow "
        f"{bool(st.overflow)}, host syncs per step {syncs.per_step:.3f}, "
        f"peak device memory {mem / 2**20:.1f} MiB, K4 launches {launches}")
    if bool(st.overflow):
        raise AssertionError(f"{label}: capacity overflow")
    if device.type == "cuda" and launches != steps:
        raise AssertionError(f"{label}: K4 launched {launches} times in "
                             f"{steps} steps")
    return st, dict(steps=steps, wall_s=wall, steps_per_s=steps / wall,
                    g=layout.g, gz=layout.gz, window=layout.window,
                    segments=final["segments"], hyphae=final["hyphae"],
                    anastomosed=final["anastomosed"],
                    total_length_mm=final["total_length_mm"],
                    overflow=bool(st.overflow),
                    syncs_per_step=syncs.per_step, peak_mib=mem / 2**20,
                    launches=launches)


def grow_full_width(preset: str, steps: int, device, **overrides):
    """Phase 9 (and 11b, the 9-cell window's run): growth at the preset's
    full width."""
    from mycelium_tpu_torch.config import GROWTH_PRESETS
    cfg = dataclasses.replace(GROWTH_PRESETS[preset], t_steps=steps,
                              **overrides)
    label = f"growth {preset}" + "".join(f", {k} {v}"
                                         for k, v in overrides.items())
    st, row = grow_run(label, cfg, device)
    return st, cfg, row


def growth_3d_path(device):
    """Phase 11a: the reference 3D deployment (``growth_3d_config``: six
    sites in a dish with z-walls, a grid of gz = 5), for its own 25 steps,
    then for 150 steps at 2^16 segment and 2^15 hypha slots. Returns (the
    150-step state, its configuration, the two runs' readings)."""
    from mycelium_tpu_torch.config import growth_3d_config
    _, short = grow_run("growth 3D, 25 steps", growth_3d_config(), device)
    cfg = growth_3d_config(t_steps=150, max_segments=1 << 16,
                           max_hyphae=1 << 15)
    st, long = grow_run("growth 3D, 150 steps", cfg, device)
    return st, cfg, {"25": short, "150": long}


def anast_reading(st, cfg, device, label: str, row: dict) -> dict:
    """K4 against its plain version on a grown state, with the tables the
    step's query builds, timed beside the plain version and its bound;
    fills ``row`` (the device time is read in the traced tail)."""
    import torch
    from mycelium_tpu_torch.kernels import anast_scan, anast_scan_plain
    from mycelium_tpu_torch.kernels.anast import window_offsets
    support = shared_checks()
    args = support.scan_args(st, cfg)
    (_, cell, _, _, gids, ggeo, gcount, _, _, _, ov_count, g, N, _, gz,
     window) = args
    k = anast_scan(*args)
    p = anast_scan_plain(*args)
    sync(device)
    # tolerance 0: the same float32 operations in the same order, the
    # fused multiply-adds computed exactly on both sides (fmaf in the
    # kernel, an exact emulation in the plain version), nothing else fused
    equal = all(torch.equal(a, b) for a, b in zip(k, p))
    rows = cell >= 0
    err = float(torch.where(k[0] == p[0], 0.0, (k[0] - p[0]).abs()).max())
    n_in = int(rows.sum())
    hits = int((k[2][rows] < N).sum())
    log(f"K4 anast_scan, {label} (g {g}, gz {gz}, window {window}): "
        f"H={cell.shape[0]} tips in the table {n_in}, with a candidate "
        f"{hits}, a grid of {gids.numel()} entries ({nbytes(ggeo) / 2**30:.3f}"
        f" GiB of geometry, {nbytes(gids) / 2**20:.1f} MiB of ids), grid "
        f"entries {int(gcount.sum())}, overlay entries "
        f"{int(ov_count.sum())}; bit-equal to plain: {equal} "
        f"(max |d2 diff| {err:.3e})")
    if not equal:
        raise AssertionError(f"K4 disagrees with its plain version: {label}")
    ms = timed_ms(lambda: anast_scan(*args), device, 50)
    pms = timed_ms(lambda: anast_scan_plain(*args), device, 2)
    # the data the function needs: every hypha's cell, each tip's slot and
    # end point, the entries of the distinct visited cells once (every z
    # cell of each window column; grid: a 4-byte id and 28 bytes of a, ab,
    # 1/|ab|^2, not the layout's pad; overlay: a 4-byte slot and its 24
    # bytes of start and end) and their three counts and offsets, the
    # outputs; a distance pair per tip and candidate of its window
    z = torch.arange(gz, device=cell.device)

    def window_cells(table_cells):
        col = table_cells // gz
        cx, cy = col // g, col % g
        out = []
        for dx, dy in window_offsets(window):
            x, y = cx + dx, cy + dy
            ok = (x >= 0) & (y >= 0) & (x < g) & (y < g)
            out.append(((x * g + y)[ok][:, None] * gz + z).reshape(-1))
        return torch.cat(out)

    def entries(c):
        return int(gcount[c].sum()) + int(ov_count[c].sum())

    pairs = entries(window_cells(cell[rows].long()))
    # what the warps load: each occupied cell of the tip table (one warp)
    # reads its window's candidates once for all its tips; in 3D the gz
    # cells of one column read the same candidates again
    loads = entries(window_cells(torch.unique(cell[rows].long())))
    uc = torch.unique(window_cells(cell[rows].long()))
    read = (cell.shape[0] * 4 + n_in * 16 + uc.numel() * 12
            + int(gcount[uc].sum()) * 32 + int(ov_count[uc].sum()) * 28)
    b4 = bound(read + cell.shape[0] * 12, pairs * 27)
    log(f"K4 time, {label}: call {ms:.4f} ms (plain {pms:.4f} ms, bound "
        f"{b4[0]:.5f} ms by {b4[1]}: {read / 2**20:.2f} MiB read, {pairs} "
        f"distance pairs, {uc.numel()} of {g * g * gz} cells; the warps "
        f"load {loads} candidates, {loads / max(entries(uc), 1):.2f}x the "
        f"{entries(uc)} distinct ones)")
    row.update(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b4[0],
               bound_by=b4[1], tips=n_in, pairs=pairs, read_mib=read / 2**20,
               candidate_loads=loads, distinct_candidates=entries(uc))
    defer_device_ms(f"K4, {label}", row, lambda: anast_scan(*args), 50)
    return row


def tie_checks(device) -> None:
    """K4 against its plain version on the tie-heavy states
    (``tests/torch_support.py``): duplicated segments, lattice points at
    bitwise-equal distances from candidates in different cells, sources
    and ranks, and in 3D in different z cells and ranks of one column,
    where only the position order decides. Bit-equal."""
    import torch
    from mycelium_tpu_torch.kernels import anast_scan, anast_scan_plain
    support = shared_checks()
    for name, make in (("2D", support.tie_state),
                       ("3D", support.tie_state_3d)):
        tcfg, tst = make(device)
        targs = support.scan_args(tst, tcfg)
        equal = all(torch.equal(a, b) for a, b in
                    zip(anast_scan(*targs), anast_scan_plain(*targs)))
        log(f"K4 anast_scan on the {name} tie-heavy state "
            f"({int((targs[1] >= 0).sum())} tips, gz {targs[-2]}): "
            f"bit-equal to plain: {equal}")
        if not equal:
            raise AssertionError("K4 disagrees with its plain version on "
                                 f"the {name} tie-heavy state")


def compare_anast(st, cfg, device, preset: str) -> dict:
    """Phase 10: K4 against its plain version on the grown state of the
    growth path (the 2D corner window) and on the tie-heavy states: the
    kernel's row."""
    row = dict(name="anast_scan", route="cuda",
               source="mycelium_tpu_torch/kernels/csrc/anast_scan.cu",
               replaces="mycelium_tpu/growth/pallas_anast.py:59",
               library_ms=None)
    anast_reading(st, cfg, device, f"2D corner window, {preset}", row)
    tie_checks(device)
    return row


def grow_plain_scan(cfg, device, on_step, env=None):
    """``run_growth``'s loop with K4 swapped for its plain version, which
    ``growth_step`` takes for this comparison only."""
    from mycelium_tpu_torch.growth.draws import TorchDraws
    from mycelium_tpu_torch.growth.state import init_state
    from mycelium_tpu_torch.growth.step import growth_step
    from mycelium_tpu_torch.kernels import anast_scan_plain
    from mycelium_tpu_torch.scenes import petri_dish
    draws = TorchDraws(cfg.seed, device)
    st, ea = init_state(cfg, petri_dish(cfg) if env is None else env,
                        device=device, draws=draws)
    walls = ea.wall_center.shape[0] > 0
    for t in range(cfg.t_steps):
        st = growth_step(st, ea, cfg, draws.step(cfg.max_hyphae,
                                                 st.sub.dtype, walls,
                                                 cfg.three_d),
                         scan=anast_scan_plain)
        on_step(t, st)
    return st


def trajectory_check(label: str, cfg, device, every: int = 25, env=None):
    """Phase 11 (and 11a's, 11d's): grow ``cfg`` (in ``env``, default the
    petri dish) twice with the same draws, through K4 (``run_growth``) and
    through its plain version; the states and their stats must be equal
    every ``every`` steps and at the end. Returns K4's final state."""
    import torch
    from mycelium_tpu_torch.growth import run_growth, summarize
    fields = ("start", "end", "theta", "phi", "sub", "state", "prev",
              "hypha", "tip", "env_e", "overflow")

    def keeper(snaps):
        def keep(t, st):
            if (t + 1) % every == 0 or t + 1 == cfg.t_steps:
                snaps[t] = [getattr(st, f).clone() for f in fields] + [
                    st.n_seg, st.n_hyp, summarize(st, cfg)]
        return keep

    t0 = time.perf_counter()
    snaps_k, snaps_p = {}, {}
    st_k, _, hist_k = run_growth(cfg, env=env, device=device,
                                 on_step=keeper(snaps_k))
    grow_plain_scan(cfg, device, keeper(snaps_p), env)
    sync(device)
    same = snaps_k.keys() == snaps_p.keys() and all(
        (torch.equal(a, b) if torch.is_tensor(a) else a == b)
        for t in snaps_k for a, b in zip(snaps_k[t], snaps_p[t]))
    log(f"trajectory {label}: {cfg.t_steps} steps through K4 and through "
        f"the plain scan, compared at steps {sorted(snaps_k)}: equal "
        f"{same}; {hist_k[-1]['segments']} segments, "
        f"{hist_k[-1]['anastomosed']} anastomosed, overflow "
        f"{bool(st_k.overflow)} ({time.perf_counter() - t0:.2f} s)")
    if not same or bool(st_k.overflow):
        raise AssertionError(f"trajectory {label}: the K4 and plain runs "
                             "differ or overflowed")
    return st_k


def many_tips_path(device) -> tuple:
    """Phase 11d (fault P11): K4 with more than 32 tips in one cell of the
    tip table, which it takes in groups of 32
    (``tests/torch_support.py::many_tips_case``: every hypha from one
    inoculum point, max_tips_per_cell 64): the 2D corner form and the 3D
    column form (gz 4) each grown through K4 and through the plain scan,
    equal at every step, the launch counts set to 0 before and read after;
    then K4 against plain on each last state, bit for bit, timed with its
    bound. Returns (the readings by form, the launch counts)."""
    from mycelium_tpu_torch.kernels import launch_counts, reset_launch_counts
    support = shared_checks()
    reset_launch_counts()
    states = {}
    for name, three_d in (("corner", False), ("column", True)):
        cfg, env = support.many_tips_case(three_d)
        states[name] = cfg, trajectory_check(
            f"P11 {name} form, more than 32 tips a cell", cfg, device,
            every=1, env=env)
    sync(device)
    counts = launch_counts()
    out = {}
    for name, (cfg, st) in states.items():
        most = int(support.scan_args(st, cfg)[13][2].max())
        log(f"P11 {name} form: the tip table's fullest cell holds {most} "
            f"tips (max_tips_per_cell {cfg.max_tips_per_cell})")
        if most <= 40:
            raise AssertionError(f"P11 {name}: no cell of more than 40 tips")
        out[name] = anast_reading(st, cfg, device,
                                  f"P11 {name} form, {most} tips a cell",
                                  {"most_tips_a_cell": most})
    return out, counts


def sharded_growth_check(device, steps: int = 20) -> tuple:
    """Phase 14a (A3b): growth with the segment slots split over the ranks
    of the one-rank group (``growth/shard.py``), the demo preset for
    ``steps`` steps, against ``run_growth`` on one device: every field,
    the counts, the grid and the stats history bit for bit; K4 launches
    once a step. The reference first, then the counts set to 0 around the
    sharded run. Returns (readings, the launch counts)."""
    import torch
    from mycelium_tpu_torch.config import GROWTH_PRESETS
    from mycelium_tpu_torch.growth import run_growth
    from mycelium_tpu_torch.growth.shard import (SlotBlocks, gathered,
                                                 run_growth_sharded)
    from mycelium_tpu_torch.kernels import launch_counts, reset_launch_counts
    cfg = dataclasses.replace(GROWTH_PRESETS["demo"], t_steps=steps)
    ref, _, hist = run_growth(cfg, device=device)
    sync(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    st_l, _, hist_n = run_growth_sharded(cfg, device=device)
    sync(device)
    wall = time.perf_counter() - t0
    counts = launch_counts()
    st = gathered(st_l, SlotBlocks(cfg.max_segments))
    fields = ("start", "end", "theta", "phi", "sub", "state", "prev",
              "hypha", "tip", "env_e", "overflow")
    unequal = [f for f in fields if not torch.equal(getattr(st, f),
                                                   getattr(ref, f))]
    unequal += [f"grid.{f}" for f in ("ids", "geo", "count")
                if not torch.equal(getattr(st.grid, f), getattr(ref.grid, f))]
    unequal += [f for f in ("n_seg", "n_hyp", "step")
                if getattr(st, f) != getattr(ref, f)]
    unequal += ["history"] * (hist_n != hist)
    log(f"sharded growth on one {torch.distributed.get_backend()} rank, "
        f"demo, {steps} steps in {wall:.3f} s ({steps / wall:.3f} steps/s), "
        f"{hist[-1]['segments']} segments, {hist[-1]['anastomosed']} "
        f"anastomosed: fields unequal to run_growth {unequal}; K4 launches "
        f"{counts['anast_scan']}")
    if unequal:
        raise AssertionError(f"sharded growth differs from run_growth: "
                             f"{unequal}")
    if device.type == "cuda" and counts["anast_scan"] != steps:
        raise AssertionError(f"sharded growth: K4 launched "
                             f"{counts['anast_scan']} times in {steps} steps")
    return dict(steps=steps, wall_s=wall, steps_per_s=steps / wall,
                segments=hist[-1]["segments"], equal=True,
                launches=counts["anast_scan"]), counts


def pipeline_3d(device, tmp) -> dict:
    """Phase 11c: the 3D pipeline. The reference 3D configuration grown for
    150 steps (its own 25 steps give a network of ~1,600 nodes that the
    grips hold whole: nothing is left to solve), exported to
    nodes.csv/elements.csv, read back, and the 40-step pull test on the
    card on the coupled pipeline's solver configuration through the route
    ``solve_route`` picks: a cold solve with the float64 residual check,
    every ramp step converged (``run_ramp`` refuses one that is not), the
    records written."""
    from mycelium_tpu_torch.config import growth_3d_config, tuned_fea_config
    from mycelium_tpu_torch.fea import run_ramp
    from mycelium_tpu_torch.fea.solve import solve_route
    from mycelium_tpu_torch.growth import run_growth
    from mycelium_tpu_torch.growth.export import export_state_geometry
    from mycelium_tpu_torch.io import read_mesh_dir, write_fea_records
    gcfg = growth_3d_config(t_steps=150, max_segments=1 << 16,
                            max_hyphae=1 << 15)
    t = {}
    t0 = time.perf_counter()
    st, _, hist = run_growth(gcfg, device=device)
    sync(device)
    t["growth_s"] = time.perf_counter() - t0
    out = os.path.join(tmp, "sim_3d")
    t0 = time.perf_counter()
    export_state_geometry(st, out)
    coords, conn = read_mesh_dir(out)
    t["mesh_s"] = time.perf_counter() - t0
    z_extent = float(coords[:, 2].max() - coords[:, 2].min())
    cfg = tuned_fea_config(n_steps=40, rtol=RTOL)
    model = timed_build(coords, conn, cfg, device, "3D pipeline")
    route = solve_route(model, cfg)
    ms, iters = cold_solve(model, coords, conn,
                           dataclasses.replace(cfg, warm_start=False),
                           device, "3D pipeline cold solve", 3,
                           limit=K6_LIMIT if route == "tree_cg"
                           else STALL_LIMIT)
    t0 = time.perf_counter()
    res = run_ramp(coords, conn, cfg, model=model)
    sync(device)
    t["ramp_s"] = time.perf_counter() - t0
    fea_dir = os.path.join(out, "fea_results")
    write_fea_records(fea_dir, res.stress_record, res.active_record,
                      res.disp_record, res.force_disp)
    n_rec = int(res.force_disp.shape[0])
    with open(os.path.join(fea_dir, "force_displacement.csv")) as f:
        fd_rows = len(f.read().splitlines()) - 1
    fractured = int((~res.active_record[-1]).sum())
    log(f"3D pipeline: {hist[-1]['segments']} segments -> "
        f"{coords.shape[0]} nodes ({z_extent:.4f} mm in z), {model.n_dof} "
        f"DOF, route {route}; cold solve {iters} iterations, median "
        f"{ms:.3f} ms; ramp {n_rec} steps recorded, every one converged, "
        f"{int(res.cg_iters.sum())} CG iterations, {fractured} elements "
        f"fractured; {sorted(os.listdir(fea_dir))} written "
        f"({fd_rows} force rows); stage wall times "
        + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
    if z_extent <= 1e-3:
        raise AssertionError("3D pipeline: the mesh is flat")
    if device.type == "cuda" and route != "tree_cg":
        raise AssertionError(f"3D pipeline: route {route}, not K6")
    if n_rec < 2 or fd_rows != n_rec or iters < 1:
        raise AssertionError(f"3D pipeline: {n_rec} steps recorded, "
                             f"{fd_rows} rows written, {iters} iterations")
    return dict(segments=hist[-1]["segments"], nodes=int(coords.shape[0]),
                dof=model.n_dof, route=route, cold_iters=iters, cold_ms=ms,
                ramp_steps=n_rec, ramp_iters=int(res.cg_iters.sum()),
                fractured=fractured, **t)


def k5_config(**overrides):
    """cg + coarse on the chain operator (the sweep's K5 leg), cold."""
    from mycelium_tpu_torch.config import FeaConfig
    base = dict(dtype="float32", rtol=SWEEP_RTOL, max_iter=SWEEP_MAX_ITER,
                operator="chain", precond="coarse", warm_start=False)
    base.update(overrides)
    return FeaConfig(**base)


# K5 against its plain version run on the CPU on copies of the same inputs
# (the set-up, the coarse inverse included, adds in the kernel's order
# there): the set-up bit for bit; x after 1 and 10 iterations and converged
# within a few float32 ulps of max |x| (the dots and the coarse rows add in
# float64 in another order, so a sum near a float32 boundary may round
# apart; 0 in every recorded run)
K5_TOL_SEQUENTIAL = 1e-6
# device operations and host syncs one cg + coarse solve may take
K5_MAX_DEVICE_OPS = 12
K5_MAX_HOST_SYNCS = 1


def k5_work(launch, cfg, iters: int) -> tuple:
    """(bytes, operations) of one K5 solve that takes ``iters``
    iterations. Bytes: the static tables and the coarse plan read once, the
    solve's inputs read once, x and the stats written once
    (``ChainCgLaunch.io_bytes``). Operations (float32 and float64 alike):
    the set-up (~160 a position for the diagonal block and its inverse, 30
    a jump entry, ~12 a coarse contribution and entry, 2·nc² to normalise),
    the Gauss-Jordan inverse (2·nc³), then per iteration ~146 a position
    (operator 45 with each slot force once, block-Jacobi 15, restriction
    and prolongation 24, dots and updates 62), 30 a jump entry and 2·nc²
    for the coarse rows."""
    from mycelium_tpu_torch.kernels.chain_cg import layout_of
    nbc, width, nbas = layout_of(launch.n, cfg)
    plan = launch.plans.get(nbc, width, nbas)
    nc, n = plan.nc, launch.n
    nj = launch.cplan.jump_ent.shape[0]
    d = 3 * nbas
    setup = 160 * n + 30 * nj + 12 * plan.blk_ent.shape[0] * d * d \
        + 2 * nc * nc
    ops = setup + 2 * nc ** 3 + iters * (146 * n + 30 * nj + 2 * nc * nc)
    return launch.io_bytes(nbc, width, nbas), ops


def k5_against_cpu(launch, cpu, args, cfg, tag: str) -> float:
    """K5 against its plain version on the CPU on copies of the same
    inputs (``args`` = active, anchored, dy_top, dy_bot, x0 on the card):
    the set-up (masks, prescribed values, start vector, block-Jacobi
    inverse, coarse matrix, its scaling and inverse) bit for bit, then x
    after 1 and 10 iterations from that set-up within K5_TOL_SEQUENTIAL,
    the iterations equal. Returns the largest error of x."""
    from mycelium_tpu_torch.devices import moved
    cpu_in = moved(args, "cpu")
    got = launch.setup(*args, cfg)
    want = cpu.setup(*cpu_in, cfg)
    bad = [k for k in want if got[k].shape != want[k].shape
           or not bool((got[k].cpu() == want[k]).all())]
    worst = max(float((got[k].cpu().double() - want[k].double()).abs()
                      .max()) for k in want)
    log(f"{tag}, set-up against the plain set-up on the CPU "
        f"({', '.join(sorted(want))}): max_abs_err={worst:.3e} (tol 0)")
    if bad or set(got) != set(want):
        raise AssertionError(f"{tag}: the set-up disagrees in {bad}")
    err_max = 0.0
    for it in (1, 10):
        ci = dataclasses.replace(cfg, max_iter=it)
        xk, sk = launch.solve(*args, ci)
        xc, sc = cpu.plain(*cpu_in, ci, setup=want)
        err, rel = rel_err([xk.cpu()], [xc])
        log(f"{tag}, {it} iterations against plain on the CPU: "
            f"max_abs_err={err:.3e} rel={rel:.3e} (tol "
            f"{K5_TOL_SEQUENTIAL:.0e}), |r| {float(sk[1]):.6e} vs "
            f"{float(sc[1]):.6e}")
        if not (rel <= K5_TOL_SEQUENTIAL
                and int(sk[0]) == int(sc[0]) == it):
            raise AssertionError(f"{tag} after {it} iterations disagrees: "
                                 f"rel {rel:.3e}")
        err_max = max(err_max, err)
    return err_max


def compare_fixed_order_sums(model, conn, cfg, device, rng, label: str,
                             min_levels: int = 1):
    """Fault P7: the sums whose terms collide on a target
    (``tests/torch_support.py::fixed_order_sums``: the chain diagonal's
    jump terms, the coarse matrix on the cluster layout of K5's
    configuration ``cfg``, the hybrid's Schur corrections and forward
    right-hand sides, and every PCR level's K2 outputs through the model's
    bound launch) on ``model``'s system 5% fractured (islands pinned):
    twice on the card, bit-equal to each other and to the CPU on copies of
    the same inputs (K2 there its plain version). Returns the largest
    |difference| from the CPU (0) and the inputs, for the timing."""
    import torch
    from mycelium_tpu_torch.devices import moved
    from mycelium_tpu_torch.fea.coarse import cluster_layout, n_basis
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    from mycelium_tpu_torch.fea.tree_solve import preconditioner_reg
    sums = shared_checks().fixed_order_sums
    active_np = rng.random(model.n_elems) > 0.05
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), active_np,
                                              grip), device=device)
    act = torch.as_tensor(active_np, device=device)
    free = model.free_nodes & anch
    _, _, nbc, width = cluster_layout(model.n_nodes, cfg)
    plan = model.coarse_plans.get(nbc, width, n_basis(cfg))
    rp = torch.as_tensor(rng.standard_normal((3, model.n_nodes)),
                         dtype=model.dtype, device=device)
    cpu = dataclasses.replace(moved(model, "cpu"), pcr_launch=None)
    args = (act, free, plan, cfg.reg, preconditioner_reg(model, cfg), rp)
    one = sums(model, *args)
    two = sums(model, *args)
    ref = sums(cpu, *moved(args, "cpu"))
    sync(device)
    bad = [n for n in ref if not (torch.equal(one[n], two[n])
                                  and torch.equal(one[n].cpu(), ref[n]))]
    err = max(float((one[n].cpu().double() - ref[n].double()).abs().max())
              if ref[n].numel() else 0.0 for n in ref)
    levels = sum(n.startswith("K2 level") for n in ref) // 4
    log(f"P7 fixed-order sums, {label} 5% fractured: chain_diag, "
        f"coarse_matrix, dacc, K2's outputs on {levels} PCR levels, racc "
        f"over them and the tail, diag_blocks and the scatter operator; two "
        f"runs and the CPU bit-equal: {not bad} "
        f"(max |diff| from the CPU {err:.3e})")
    if bad or levels < min_levels:
        raise AssertionError(f"P7 {label}: not bit-equal twice and to the "
                             f"CPU: {bad}; {levels} PCR levels")
    # the dense tail: its matrix is one of the sums above; its inverse
    # (torch.linalg.inv) twice from two factorizations
    from mycelium_tpu_torch.fea.solve import compute_tree_factor
    hcfg = dataclasses.replace(cfg, precond="tree", tree_coarse_weight=0.0)
    inv1 = compute_tree_factor(model, act, hcfg, anch).sinv.clone()
    inv2 = compute_tree_factor(model, act, hcfg, anch).sinv
    sync(device)
    same = torch.equal(inv1, inv2)
    log(f"dense tail {label}: {inv1.shape[0] // 3} slots, matrix bit-equal "
        f"twice and to the CPU: {'dense tail matrix' in ref and not bad}, "
        f"inverse bit-equal twice: {same}")
    if "dense tail matrix" not in ref or not same:
        raise AssertionError(f"dense tail {label}: no tail, or its inverse "
                             "differs between two factorizations")
    return err, plan, act, free


def time_ordered_sum(model, plan, act, free, cfg, device, rng,
                     err: float) -> dict:
    """The fixed-order sum kernel alone on the coarse matrix's sum (its
    longest segments), against its plain version on the CPU, timed."""
    import torch
    from mycelium_tpu_torch.fea.coarse import coarse_matrix
    from mycelium_tpu_torch.kernels.ordered_sum import (ordered_sum,
                                                        ordered_sum_plain)
    terms = torch.as_tensor(rng.standard_normal(
        (int(plan.blk_ent.shape[0]), (3 * plan.nbas) ** 2)),
        dtype=torch.float64, device=device).T
    nblk = int(plan.blk_row.shape[0])
    k = ordered_sum(terms, plan.blk_ptr, None, nblk, long_segments=True)
    p = ordered_sum_plain(terms.cpu(), plan.blk_ptr.cpu(), None, nblk)
    if not torch.equal(k.cpu(), p):
        raise AssertionError("ordered_sum disagrees with its plain version "
                             "on the CPU")
    ms = timed_ms(lambda: ordered_sum(terms, plan.blk_ptr, None, nblk,
                                      long_segments=True), device, 50)
    pms = timed_ms(lambda: ordered_sum_plain(terms, plan.blk_ptr, None,
                                             nblk), device, 20)
    lib = timed_ms(lambda: coarse_matrix(plan, model.chain, act,
                                         free[model.chain.perm], cfg.reg,
                                         model.dtype), device, 20)
    # bytes: the terms and the pointers read once, the sums written; one
    # float64 add a term
    b = bound(nbytes(terms, plan.blk_ptr) + nblk * terms.shape[0] * 8,
              terms.numel())
    log(f"ordered_sum time (coarse blocks: {nblk} segments, "
        f"{terms.shape[1]} terms, {terms.shape[0]} entries each) call "
        f"{ms:.4f} ms (plain {pms:.4f} ms, the whole coarse_matrix "
        f"{lib:.4f} ms, bound {b[0]:.5f} ms by {b[1]})")
    row = dict(name="ordered_sum", route="cuda",
               source="mycelium_tpu_torch/kernels/csrc/ordered_sum.cu",
               replaces="mycelium_tpu/fea/tree_jax.py:698",
               max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=b[0],
               bound_by=b[1], library_ms=None, coarse_matrix_ms=lib)
    defer_device_ms("ordered_sum", row, lambda: ordered_sum(
        terms, plan.blk_ptr, None, nblk, long_segments=True), 50)
    return row


def time_ordered_sum_short(model, row: dict, device) -> None:
    """The fixed-order sum on the hybrid's short segments at ``model``'s
    shapes (the Schur corrections ``dacc``: the attachment CSR by junction
    slot, 9 components, 0-3 terms a slot), against its plain version on
    the CPU, timed into ``row`` beside the coarse blocks' numbers."""
    import torch
    from mycelium_tpu_torch.kernels.ordered_sum import (ordered_sum,
                                                        ordered_sum_plain)
    tree = model.tree
    S, P = tree.n_slots, tree.n_paths
    vals = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (2 * P, 9)), dtype=torch.float32, device=device).T
    ptr, ent = tree.att_ptr, tree.att_ent

    def call():
        return ordered_sum(vals, ptr, ent, S)

    k = call()
    p = ordered_sum_plain(vals.cpu(), ptr.cpu(), ent.cpu(), S)
    same = torch.equal(k.cpu(), p)
    ms = timed_ms(call, device, 100)
    pms = timed_ms(lambda: ordered_sum_plain(vals, ptr, ent, S), device, 20)
    # the terms at the CSR's entries, the pointers and entries, the sums
    b = bound(ent.numel() * (9 * 4 + 4) + nbytes(ptr) + 9 * S * 4,
              ent.numel() * 9)
    log(f"ordered_sum short segments ({S} slots, {ent.numel()} terms, 9 "
        f"components): equal to plain on the CPU {same}; call {ms:.4f} ms "
        f"(plain {pms:.4f} ms, bound {b[0]:.6f} ms by {b[1]})")
    if not same:
        raise AssertionError("ordered_sum disagrees with its plain version "
                             "on the CPU on the short segments")
    row.update(short_ms=ms, short_plain_ms=pms, short_bound_ms=b[0])
    defer_device_ms("ordered_sum short segments", row, call, 100,
                    "short_device_ms", "short_ms")


def anchored_reading(model, conn, device, rng, row: dict,
                     suffix: str) -> None:
    """K7 on one model, into ``row`` under keys ending in ``suffix``: its
    mask against ``anchored_mask_host`` (scipy) on the intact mask, 10
    drawn masks with 1-50% of the elements inactive and the top grip cut
    off, element for element (the run fails on a difference); then the
    kernel alone timed on a 5% fractured mask beside its byte bound and the
    plain ``tree_anchored`` (the path it replaced) on the same mask."""
    import torch
    from mycelium_tpu_torch.fea.ramp import (anchored_mask_host,
                                             refresh_anchored)
    from mycelium_tpu_torch.fea.tree_factor import tree_anchored
    label = f"K7 anchored, {model.n_dof} DOF"
    conn = np.asarray(conn, np.int64)
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    top = model.top_nodes.cpu().numpy()
    if device.type == "cuda":
        k7 = model.anchored_launch.mask
    else:
        def k7(a):
            return refresh_anchored(model, a)
    masks = [np.ones(model.n_elems, bool),
             ~(top[conn[:, 0]] | top[conn[:, 1]])]
    masks += [rng.random(model.n_elems) >= f
              for f in np.linspace(0.01, 0.5, 10)]
    off = islands = 0
    for act_np in masks:
        host = anchored_mask_host(conn, act_np, grip)
        got = k7(torch.as_tensor(act_np, device=device)).cpu().numpy()
        off += int((got != host).sum())
        islands += int((~host).sum())
    act = torch.as_tensor(rng.random(model.n_elems) >= 0.05, device=device)
    ms = timed_ms(lambda: k7(act), device, 50)
    pms = timed_ms(lambda: tree_anchored(model.tree, model, act), device, 5)
    b = bound(model.anchored_launch.io_bytes(), 0)
    log(f"{label}: {len(masks)} masks, {off} nodes off scipy's ({islands} "
        f"unanchored in all); call {ms:.4f} ms (plain tree_anchored "
        f"{pms:.3f} ms, {pms / ms:.0f}x; bound {b[0]:.5f} ms by {b[1]})")
    if off:
        raise AssertionError(f"{label}: {off} nodes differ from "
                             "anchored_mask_host")
    row.update({f"ms{suffix}": ms, f"plain_ms{suffix}": pms,
                f"bound_ms{suffix}": b[0], "bound_by": b[1],
                "max_abs_err": max(row.get("max_abs_err", 0.0),
                                   float(off))})
    defer_device_ms(label, row, lambda: k7(act), 50, f"device_ms{suffix}",
                    f"ms{suffix}")


def compare_anchored(model, conn, model_b, conn_b, device, rng) -> dict:
    """Phase 6a: K7 against scipy at 22,125 and 309k DOF, each timed
    (``anchored_reading``); the row's numbers are the 309k ones, the 22k
    ones ride beside them."""
    row = dict(name="anchored", route="cuda",
               source="mycelium_tpu_torch/kernels/csrc/anchored.cu",
               replaces=None, library_ms=None)
    anchored_reading(model_b, conn_b, device, rng, row, "")
    anchored_reading(model, conn, device, rng, row, "_22k")
    return row


def post_solve_reading(model, cfg, device, row: dict, suffix: str) -> None:
    """K8 on one model, into ``row`` under keys ending in ``suffix``: its
    rows (stress, mask, disp, status, flag) against ``post_solve_plain`` on
    CPU copies of the same inputs, bit for bit (the run fails on a
    difference), under a zero displacement on the intact mask and under
    displacements drawn so that some elements pass the fracture strain, on
    the intact mask, the top grip cut off and 5 masks with 1-50% of the
    elements inactive; then the step as the ramp launches it
    (``fea.ramp.post_solve`` into one set of rows, as ``_DeviceRecords``
    hands them) timed on a 5% fractured mask, beside K8's byte bound and
    the plain counterpart on the card."""
    import torch
    from mycelium_tpu_torch.fea.elements import ElementGeometry
    from mycelium_tpu_torch.fea.ramp import post_solve
    from mycelium_tpu_torch.kernels import post_solve_plain
    label = f"K8 post_solve, {model.n_dof} DOF"
    launch = model.post_launch
    # its own generator: the later phases draw what they drew before
    rng = np.random.default_rng(8)
    conn = model.conn.cpu().numpy()
    top = model.top_nodes.cpu().numpy()
    g = model.geom
    cpu = dict(conn=model.conn.cpu(), top=model.top_nodes.cpu(),
               geom=ElementGeometry(n=g.n.cpu(), length=g.length.cpu(),
                                    k_ax=g.k_ax.cpu(), k_bd=g.k_bd.cpu()))
    # std of an element's axial stretch 0.71 max_strain·L: ~16% of the
    # active elements pass the fracture strain
    scale = 0.5 * cfg.max_strain * float(g.length.median())
    masks = [np.ones(model.n_elems, bool),
             ~(top[conn[:, 0]] | top[conn[:, 1]])]
    masks += [rng.random(model.n_elems) >= f
              for f in np.linspace(0.01, 0.5, 5)]
    cases = [(np.zeros((model.n_nodes, 3)), masks[0])]
    cases += [(rng.standard_normal((model.n_nodes, 3)) * scale, m)
              for m in masks]
    off = fractured = 0
    for k, (u_np, act_np) in enumerate(cases):
        u = torch.as_tensor(u_np, dtype=model.dtype, device=device)
        act = torch.as_tensor(act_np, device=device)
        got = launch.launch(u, act, launch.rows(), cfg.e_mod,
                            cfg.max_strain, k % 2 == 0, k)
        want = post_solve_plain(u.cpu(), cpu["conn"], cpu["geom"],
                                cpu["top"], act.cpu(), cfg.e_mod,
                                cfg.max_strain, k % 2 == 0, k)
        for a, b in zip(got, want):
            a = a.cpu().numpy().reshape(-1).view(np.uint8)
            off += int((a != b.numpy().reshape(-1).view(np.uint8)).sum())
        fractured += int(act_np.sum()) - int(want.status[1])
    u = torch.as_tensor(rng.standard_normal((model.n_nodes, 3)) * scale,
                        dtype=model.dtype, device=device)
    act = torch.as_tensor(rng.random(model.n_elems) >= 0.05, device=device)
    rows = launch.rows()

    def step():
        return post_solve(model, cfg, u, act, rows, True, 7)

    ms = timed_ms(step, device, 50)
    pms = timed_ms(lambda: post_solve_plain(
        u, model.conn, g, model.top_nodes, act, cfg.e_mod, cfg.max_strain,
        True, 7), device, 5)
    b = bound(launch.io_bytes(), 0)
    log(f"{label}: {len(cases)} inputs, {off} bytes off the plain "
        f"counterpart's ({fractured} elements fractured in all); call "
        f"{ms:.4f} ms (plain {pms:.3f} ms, {pms / ms:.0f}x; bound "
        f"{b[0]:.5f} ms by {b[1]}, {launch.io_bytes()} B)")
    if off:
        raise AssertionError(f"{label}: {off} bytes differ from "
                             "post_solve_plain")
    if not fractured:
        raise AssertionError(f"{label}: no input fractured an element")
    row.update({f"ms{suffix}": ms, f"plain_ms{suffix}": pms,
                f"bound_ms{suffix}": b[0], "bound_by": b[1],
                "max_abs_err": max(row.get("max_abs_err", 0.0),
                                   float(off))})
    defer_device_ms(label, row, step, 50, f"device_ms{suffix}",
                    f"ms{suffix}")


def compare_post_solve(model, cfg, model_b, cfg_b, device) -> dict:
    """Phase 6b: K8 against its plain counterpart at 22,125 and 309k DOF,
    each timed (``post_solve_reading``); the row's numbers are the 309k
    ones, the 22k ones ride beside them."""
    row = dict(name="post_solve", route="cuda",
               source="mycelium_tpu_torch/kernels/csrc/post_solve.cu",
               replaces=None, library_ms=None)
    post_solve_reading(model_b, cfg_b, device, row, "")
    post_solve_reading(model, cfg, device, row, "_22k")
    return row


def forest_oracle_check(model, coords, conn, cfg, device) -> dict:
    """A8: one forest apply of the hybrid on the intact system (K2
    factoring and K3 applying, through the model's ``PcrLaunch``) against
    the numpy oracle ``fea/tree.py::tree_factor_np`` / ``tree_apply_np``
    in float64 on the host: the same active and free masks, the same
    right-hand side, the same regularisation, the model's dense tail (the
    settings under which tests/test_torch_tree_factor.py holds the
    factorization to the oracle in float64). Within FOREST_F32_TOL of
    max |z|, K2 and K3 launched, or the run fails."""
    import torch
    from mycelium_tpu_torch.fea.elements import element_geometry_host
    from mycelium_tpu_torch.fea.solve import compute_tree_factor
    from mycelium_tpu_torch.fea.tree import (build_tree_schedule, element_k3,
                                             tree_apply_np, tree_factor_np)
    from mycelium_tpu_torch.fea.tree_factor import tree_apply_chain_planes
    from mycelium_tpu_torch.kernels import launch_counts, reset_launch_counts
    free = model.free_nodes.cpu().numpy()
    perm = model.chain.perm.cpu().numpy()
    r = np.random.default_rng(12).standard_normal((model.n_nodes, 3))
    r[~free] = 0.0
    reset_launch_counts()
    act = torch.ones(model.n_elems, dtype=torch.bool, device=device)
    factor = compute_tree_factor(model, act, cfg)
    z = tree_apply_chain_planes(
        model.tree, factor, torch.as_tensor(r[perm].T.copy(),
                                            dtype=model.dtype, device=device),
        model.pcr_launch).double().cpu().numpy().T
    counts = launch_counts()
    t0 = time.perf_counter()
    sch = build_tree_schedule(np.asarray(conn), model.n_nodes, free,
                              max_path_len=cfg.tree_max_path_len)
    n, _, k_ax, k_bd = element_geometry_host(coords, np.asarray(conn), cfg)
    reg = max(cfg.reg, cfg.tree_reg_rel * model.tree.meta.k_scale)
    ref = tree_apply_np(tree_factor_np(
        sch, element_k3(n, k_ax, k_bd), np.ones(model.n_elems, bool), free,
        reg), r)[perm][:model.tree.n_slots]
    err = float(np.abs(z - ref).max())
    rel = err / float(np.abs(ref).max())
    log(f"A8: hybrid forest apply ({model.n_dof} DOF, "
        f"{len(model.pcr_launch.sizes)} PCR levels, K2 "
        f"{counts['pcr_factor']} and K3 {counts['pcr_apply']} launches) "
        f"against the float64 numpy oracle: max |z - oracle| {err:.3e}, "
        f"{rel:.3e} of max |z| (tol {FOREST_F32_TOL:.0e}); oracle "
        f"{time.perf_counter() - t0:.2f} s")
    if device.type == "cuda" and (counts["pcr_factor"] < 1
                                  or counts["pcr_apply"] < 1):
        raise AssertionError(f"A8: K2 or K3 not launched: {counts}")
    if not rel <= FOREST_F32_TOL:
        raise AssertionError(f"A8: the hybrid's forest apply is {rel:.3e} "
                             f"of max |z| off the oracle")
    return dict(max_abs_err=err, rel_err=rel)


def hybrid_apply_check(model, cfg, device) -> dict:
    """One apply of the hybrid's forest preconditioner (``model`` as a
    model that cannot run K6 takes it; coarse weight 0, so the apply is
    the forest's alone) on a random residual: 2 K3 launches a PCR level
    and at most one ordered_sum, or the run fails. Its device operations,
    and a factorization's, are read in the traced tail."""
    import torch
    from mycelium_tpu_torch.fea.solve import (chain_preconditioner,
                                              compute_tree_factor)
    from mycelium_tpu_torch.kernels import launch_counts, reset_launch_counts
    cfg = dataclasses.replace(cfg, tree_coarse_weight=0.0)
    act = torch.ones(model.n_elems, dtype=torch.bool, device=device)
    pc = chain_preconditioner(model, act, cfg, model.free_nodes)
    r = torch.as_tensor(np.random.default_rng(10).standard_normal(
        (3, model.n_nodes)), dtype=model.dtype, device=device)
    pc(r)
    sync(device)
    reset_launch_counts()
    pc(r)
    sync(device)
    counts = launch_counts()
    L = len(model.pcr_launch.sizes)
    log(f"hybrid forest apply ({model.n_dof} DOF, {L} PCR levels): "
        f"launches {counts}")
    if device.type == "cuda" and (counts["pcr_apply"] != 2 * L
                                  or counts["ordered_sum"] > 1):
        raise AssertionError(f"hybrid tree apply: {counts['pcr_apply']} K3 "
                             f"launches for {L} PCR levels, "
                             f"{counts['ordered_sum']} ordered_sum")
    out = dict(k3_launches=counts["pcr_apply"],
               ordered_sum_launches=counts["ordered_sum"])

    def ops(device):
        if device.type != "cuda":
            return
        from mycelium_tpu_torch.profile_fea import profile
        for name, fn, n in (("apply", lambda: pc(r), 20), ("factor", lambda:
                            compute_tree_factor(model, act, cfg), 5)):
            prof = profile(fn, n, 1.0, None)
            out[f"{name}_device_ops"] = prof["device_ops_per_solve"]
            out[f"{name}_device_busy_ms"] = prof["device_busy_ms"]
        log(f"hybrid forest apply {model.n_dof} DOF: "
            f"{out['apply_device_ops']:.1f} device operations "
            f"({out['apply_device_busy_ms']:.4f} ms busy); its "
            f"factorization {out['factor_device_ops']:.1f} "
            f"({out['factor_device_busy_ms']:.4f} ms busy)")

    defer(ops)
    return out


def compare_chain_cg(model, conn, cfg, device, rng, barrier_us) -> dict:
    """Phase 4: K5 against its plain version on the CPU on copies of the
    same inputs, on the full ramp system of the mesh with 5% of its
    elements fractured (islands pinned), const and linear basis: the
    set-up bit for bit and x after 1 and 10 iterations (``k5_against_cpu``);
    converged (const), the iterations equal, within K5_TOL_SEQUENTIAL; two
    launches bit-equal (no float atomics). Times the kernel, its plain
    version and, deferred to the traced tail, its device time by iteration
    cap; the latency floor is the iterations times three barriers times
    the barrier's cost at K5's grid (``barrier_us``)."""
    import torch
    from mycelium_tpu_torch.devices import moved
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    from mycelium_tpu_torch.kernels.chain_cg import barrier_count, layout_of
    launch = model.chain_launch
    cpu = launch.on("cpu")
    active_np = rng.random(model.n_elems) > 0.05
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), active_np,
                                              grip), device=device)
    active = torch.as_tensor(active_np, device=device)
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=device)
    dy = cfg.displacement_max
    cpu_in = moved((active, anch), "cpu")
    err_max = max(k5_against_cpu(
        launch, cpu, (active, anch, dy, -dy, x0),
        dataclasses.replace(cfg, coarse_basis=basis),
        f"K5 chain_cg {basis} basis") for basis in ("const", "linear"))
    xk, sk = launch.solve(active, anch, dy, -dy, x0, cfg)
    xk, sk = xk.clone(), sk.clone()
    xk2, sk2 = launch.solve(active, anch, dy, -dy, x0, cfg)
    sync(device)
    same = torch.equal(xk, xk2) and torch.equal(sk, sk2)
    xc, sc = cpu.plain(*cpu_in, dy, -dy, x0.cpu(), cfg)
    ik, ic = int(sk[0]), int(sc[0])
    conv = float(sk[1]) <= float(sk[2]) and float(sc[1]) <= float(sc[2])
    err, rel = rel_err([xk.cpu()], [xc])
    nbc, width, nbas = layout_of(launch.n, cfg)
    nc = launch.plans.get(nbc, width, nbas).nc
    nbar = launch.last_barriers() if device.type == "cuda" else 0
    grid = launch._bound[(nbc, width, nbas)]["grid"] \
        if device.type == "cuda" else 0
    log(f"K5 chain_cg converged {conv}: {ik} iterations (plain on the CPU "
        f"{ic}), max_abs_err={err:.3e} rel={rel:.3e} (tol "
        f"{K5_TOL_SEQUENTIAL:.0e}), two launches bit-equal: {same}; grid "
        f"{grid} blocks for {nbc} clusters of {width}, nc {nc}, {nbar} "
        f"grid-wide barriers ({barrier_count(nc, ik)} by the rule)")
    if not (conv and same and ik == ic and rel <= K5_TOL_SEQUENTIAL):
        raise AssertionError("K5 disagrees with its plain version on the "
                             "CPU or is not deterministic")
    if device.type == "cuda" and nbar != barrier_count(nc, ik):
        raise AssertionError(f"K5: {nbar} barriers, the rule says "
                             f"{barrier_count(nc, ik)}")
    err_max = max(err_max, err)

    def solve(c=cfg):
        return launch.solve(active, anch, dy, -dy, x0, c)

    ms = timed_ms(solve, device, 5)
    pms = timed_ms(lambda: cpu.plain(*cpu_in, dy, -dy, x0.cpu(), cfg),
                   torch.device("cpu"), 1)
    io, ops = k5_work(launch, cfg, ik)
    b5 = bound(io, ops)
    us = barrier_us.get(grid, 0.0) if barrier_us else 0.0
    floor = barrier_count(nc, ik) * us * 1e-3
    log(f"K5 time call {ms:.4f} ms a solve ({ik} iterations, "
        f"{ms * 1e3 / max(ik, 1):.2f} us an iteration; plain on the CPU "
        f"{pms:.4f} ms, bound {b5[0]:.6f} ms by {b5[1]}: {io:,} B "
        f"({bound(io, 0)[0]:.6f} ms), {ops:,} op ({bound(0, ops)[0]:.6f} "
        f"ms); latency floor {floor:.4f} ms: "
        f"{barrier_count(nc, ik)} barriers at {us:.3f} us)")
    row = dict(name="chain_cg", route="cuda",
               source="mycelium_tpu_torch/kernels/csrc/chain_cg.cu",
               replaces="mycelium_tpu/fea/pallas_cg.py:196",
               max_abs_err=err_max, ms=ms, plain_ms=pms, bound_ms=b5[0],
               bound_by=b5[1], library_ms=None, iterations=ik,
               barriers=barrier_count(nc, ik), grid=grid,
               latency_floor_ms=floor)
    defer_device_ms("K5", row, solve, 5)

    def by_cap(device):
        """K5's device time with the iteration cap at 0 (the set-up and
        the coarse inverse), 1 and 10, beside converged, and its slope."""
        cap = {c: device_ms(lambda c=c: solve(dataclasses.replace(
            cfg, max_iter=c)), device, 5) for c in (0, 1, 10)}
        slope = (row["device_ms"] - cap[10]) * 1e3 / max(ik - 10, 1)
        log(f"K5 device time by iteration cap: 0 (set-up, coarse inverse) "
            f"{cap[0]:.4f} ms, 1 {cap[1]:.4f} ms, 10 {cap[10]:.4f} ms, "
            f"converged ({ik}) {row['device_ms']:.4f} ms: {slope:.2f} us an "
            f"iteration; latency floor {floor:.4f} ms")
        row.update(device_ms_cap0=cap[0], device_ms_cap1=cap[1],
                   device_ms_cap10=cap[10], device_us_per_iteration=slope)

    defer(by_cap)
    return row


def tree_cg_work(model, iters: int) -> tuple:
    """(bytes, operations, streamed bytes) of one K6 solve of ``model``
    that takes ``iters`` iterations. Bytes: the static tables the kernel is
    handed and the solve's inputs (the active and free masks, x0) read
    once, x and the stats written once (``TreeCgLaunch.io_bytes``).
    Operations: the set-up (~120 a slot for the diagonal and couplings, 12 a
    position), the factorization once (per slot and round 563, a last
    inverse 131, per path ~500 for the corner blocks and Schur products),
    then per iteration the operator (45 a position: each slot force once,
    30 a jump entry), two level applies (36 a slot and round plus 15), and
    the dots and updates (42 a position). Streamed: what the phases move
    between barriers, the factorization's coefficients once (~150 B a slot
    and round; the state stays in shared memory on a windowed level) and
    per iteration the coefficients twice and the vectors."""
    meta, tk = model.tree.meta, model.tree_tables
    n, S, P = model.n_nodes, model.tree.n_slots, model.tree.n_paths
    sizes = [b - a for a, b in zip(meta.level_offsets,
                                   meta.level_offsets[1:])]
    io = model.tree_launch.io_bytes()
    fac = sum(sl * (k * 563 + 131) for sl, k in zip(sizes, meta.level_steps))
    app = sum(sl * (k * 36 + 15) for sl, k in zip(sizes, meta.level_steps))
    nj = model.chain.jump_ent.shape[0]
    ops = (120 * S + 12 * n + fac + 500 * P
           + (iters + 1) * (2 * app + 87 * n + 30 * nj))
    coef = 4 * 2 * tk.coef_floats
    stream = (sum((150 if w else 250) * sl * k for sl, k, w in
                  zip(sizes, meta.level_steps, tk.windowed))
              + (iters + 1) * (2 * coef + 4 * 9 * 2 * S + 4 * 3 * 10 * n))
    return io, ops, stream


# K6 against its plain version on the card, per mesh: the bound on one
# preconditioner apply (random vector) and on x after one iteration of the
# load case, both as a share of the largest entry. The two sides do the same
# float32 operations, but on the card the plain version adds a junction's
# Schur corrections and attachment products (and the diagonal's jump terms)
# with index_add_ (float atomics, any order) where the kernel adds them in
# a fixed order; every further level's adjugate inverses amplify that
# difference, so the bound grows with the levels: about 8 times the largest
# reading of the runs recorded in PERF.md (7.1e-6, 6.6e-5 and 8.3e-5); on
# the scaling path's deeper forests (1.02M and 3M DOF) 8 times a reading
# extrapolated from those before it was taken
K6_TOL = {"22k": 5e-5, "99k": 5e-4, "309k": 5e-4, "1.02M": 1e-3,
          "3M": 2e-3}
# K6 against its plain version run on the CPU on copies of the same inputs,
# where index_add_ adds one term after another in the kernel's order: equal
# bit for bit in every recorded run; the bound leaves a few float32 ulps for
# a host whose vector sums round otherwise
K6_TOL_SEQUENTIAL = 1e-6
# device operations and host syncs one K6 solve may take
K6_MAX_DEVICE_OPS = 12
K6_MAX_HOST_SYNCS = 1


def solve_args(model, cfg, active, anchored, dy_top, dy_bot, x0) -> tuple:
    """The arguments of ``TreeCgLaunch.solve`` (and ``.plain``) for one
    solve of ``model`` under ``cfg``."""
    from mycelium_tpu_torch.fea.solve import free_mask
    from mycelium_tpu_torch.fea.tree_solve import preconditioner_reg
    return (active, free_mask(model, anchored), dy_top, dy_bot, x0, cfg.rtol,
            cfg.reg, preconditioner_reg(model, cfg), cfg.max_iter)


def compare_tree_setup(launch, cpu_launch, args, tag: str) -> None:
    """The kernel's set-up phase, launched alone, against the plain set-up
    on the CPU on copies of the same inputs: the masks, the prescribed
    values and the start vector in chain order, the forest diagonal, the
    left-edge and the attachment couplings. Tolerance 0: the kernel adds a
    position's jump terms in the order of the jump CSR, which is the order
    of a sequential index_add_; every other entry is one thread's
    arithmetic in the plain version's order."""
    from mycelium_tpu_torch.devices import moved
    active, free, dy_top, dy_bot, x0, _, _, reg_pc, _ = args
    got = launch.setup(active, free, dy_top, dy_bot, x0, reg_pc)
    want = cpu_launch.setup(*moved((active, free), "cpu"), dy_top, dy_bot,
                            x0.cpu(), reg_pc)
    bad = [k for k in want if got[k].shape != want[k].shape
           or not bool((got[k].cpu() == want[k]).all())]
    worst = max(float((got[k].cpu().double() - want[k].double()).abs().max())
                for k in want)
    log(f"{tag}, set-up phase against the plain set-up on the CPU "
        f"({', '.join(sorted(want))}): max_abs_err={worst:.3e} (tol 0)")
    if bad or set(got) != set(want):
        raise AssertionError(f"{tag}: the set-up disagrees in {bad}")


def solve_footprint(solve, device, label: str) -> dict:
    """Device operations and host syncs of one call of ``solve``, as
    ``profile_fea`` counts them."""
    if device.type != "cuda":
        return dict(device_ops=0.0, host_syncs=0.0)
    from mycelium_tpu_torch.profile_fea import profile, syncs_per_solve
    n_syncs, sites = syncs_per_solve(solve, 3)
    prof = profile(solve, 3, 1.0, None)
    log(f"{label}: {prof['device_ops_per_solve']:.1f} device operations "
        f"(device busy {prof['device_busy_ms']:.4f} ms) and {n_syncs:.1f} "
        f"host syncs a solve {sites}; largest: "
        f"{prof['top_kernels_ms_per_solve'][:3]}")
    return dict(device_ops=prof["device_ops_per_solve"], host_syncs=n_syncs,
                device_busy_ms=prof["device_busy_ms"])


def barrier_probe(device, extra=()) -> dict:
    """What one grid-wide barrier costs on cooperative grids of 33 to 264
    blocks (and ``extra`` sizes) of K5's and K6's block size with no work
    between the barriers: the difference of a launch with 2,000 barriers
    and one with none."""
    from mycelium_tpu_torch.kernels.tree_cg import barrier_probe as probe
    out = {}
    for grid in sorted({33, 66, 132, 264, *extra}):
        base = timed_ms(lambda: probe(grid, 0, device), device, 20)
        full = timed_ms(lambda: probe(grid, 2000, device), device, 20)
        out[grid] = (full - base) / 2000 * 1e3
    log("grid-wide barrier, microseconds each by blocks of the grid: "
        + ", ".join(f"{g}: {us:.3f}" for g, us in out.items()))
    return out


def compare_tree_cg(model, conn, cfg, device, rng, size: str,
                    timed: bool) -> dict:
    """Phases 5 and 6: K6 against its plain version, intact and with 5% of
    the elements fractured (islands pinned), at the shapes of the mesh
    ``size`` (a key of K6_TOL). Each result is held against the plain
    version on the card (K6_TOL[size], the noise of its atomics) and
    against the plain version on the CPU on copies of the same inputs
    (K6_TOL_SEQUENTIAL), which is what can see a fault in a small level.

    - The set-up phase's outputs against the plain set-up on the CPU.
    - One apply of the factored preconditioner on a rough vector: zero load,
      a random start x0, one iteration, so that x1 - x0 = alpha·M^-1(-A x0)
      passes every level's factorization, fills, flips and attachment
      products on data with no smoothness to hide a fault.
    - The load case after one iteration.
    - Converged: within 1e-5 of the card's plain version, the iterations
      within 1, and two launches bit-equal (no float atomics in the
      kernel)."""
    import torch
    from mycelium_tpu_torch.bench.roofline import solver_traffic_bytes
    from mycelium_tpu_torch.devices import moved
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    from mycelium_tpu_torch.kernels.tree_cg import barrier_count
    tol = K6_TOL[size]
    launch = model.tree_launch
    cpu_launch = launch.on("cpu")
    tk = model.tree_tables
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    zero = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=device)
    rough = torch.as_tensor(rng.standard_normal((model.n_nodes, 3)),
                            dtype=model.dtype, device=device)
    dy = cfg.displacement_max
    off = model.tree.meta.level_offsets
    n_win = np.diff(tk.wlv[0].cpu().numpy()).tolist()
    log(f"K6 tree_cg {size}: levels of "
        f"{[b - a for a, b in zip(off, off[1:])]} slots, rounds "
        f"{model.tree.meta.level_steps}; on path-aligned windows of at most "
        f"{tk.window} slots: {list(tk.windowed)} ({n_win} windows), the rest "
        f"on global rounds")

    def one_step(tag, args):
        """K6, plain on the card and plain on the CPU after one iteration;
        the change of x, so that a start vector does not hide it."""
        args = args[:-1] + (1,)
        start = args[1][:, None] * args[4]   # free·x0: every side's start
        (xk, sk), (xp, sp) = launch.solve(*args), launch.plain(*args)
        xc, sc = cpu_launch.plain(*moved(args, "cpu"))
        err, rel = rel_err([xk - start], [xp - start])
        err_c, rel_c = rel_err([(xk - start).cpu()], [xc - start.cpu()])
        log(f"{tag}: against plain on the card max_abs_err={err:.3e} "
            f"rel={rel:.3e} (tol {tol:.0e}), against plain on the CPU "
            f"max_abs_err={err_c:.3e} rel={rel_c:.3e} (tol "
            f"{K6_TOL_SEQUENTIAL:.0e}); |r| {float(sk[1]):.6e}, "
            f"{float(sp[1]):.6e}, {float(sc[1]):.6e}")
        if not (rel <= tol and rel_c <= K6_TOL_SEQUENTIAL
                and int(sk[0]) == int(sp[0]) == int(sc[0]) == 1):
            raise AssertionError(f"{tag}: disagrees: rel {rel:.3e} (card), "
                                 f"{rel_c:.3e} (CPU)")
        return max(err, err_c)

    err_max, args, ik = 0.0, None, 0
    for frac in (0.05, 0.0):
        active_np = rng.random(model.n_elems) >= frac
        anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), active_np,
                                                  grip), device=device)
        active = torch.as_tensor(active_np, device=device)
        tag = f"K6 tree_cg {size}, {frac:.0%} fractured"
        rough_args = solve_args(model, cfg, active, anch, 0.0, 0.0, rough)
        compare_tree_setup(launch, cpu_launch,
                           solve_args(model, cfg, active, anch, dy, -0.5 * dy,
                                      rough), tag)
        err_max = max(err_max, one_step(
            f"{tag}, one apply on a random vector", rough_args))
        args = solve_args(model, cfg, active, anch, dy, -dy, zero)
        err_max = max(err_max, one_step(f"{tag}, 1 iteration", args))
        (xk, sk), (xp, sp) = launch.solve(*args), launch.plain(*args)
        xc, sc = cpu_launch.plain(*moved(args, "cpu"))
        xk2, sk2 = launch.solve(*args)
        sync(device)
        same = torch.equal(xk, xk2) and torch.equal(sk, sk2)
        ik, ip, ic = int(sk[0]), int(sp[0]), int(sc[0])
        conv = float(sk[1]) <= float(sk[2]) and float(sp[1]) <= float(sp[2])
        err, rel = rel_err([xk], [xp])
        err_c, rel_c = rel_err([xk.cpu()], [xc])
        nbar = launch.last_barriers() if device.type == "cuda" else 0
        log(f"{tag}, converged {conv}: {ik} iterations (plain {ip}, on the "
            f"CPU {ic}), max_abs_err={err:.3e} rel={rel:.3e} (tol 1e-5), "
            f"against plain on the CPU max_abs_err={err_c:.3e} "
            f"rel={rel_c:.3e} (tol {K6_TOL_SEQUENTIAL:.0e}), two launches "
            f"bit-equal: {same}; {nbar} grid-wide barriers in the launch "
            f"({barrier_count(tk, ik)} by the rule)")
        if not (conv and same and abs(ik - ip) <= 1 and rel <= 1e-5
                and ik == ic and rel_c <= K6_TOL_SEQUENTIAL):
            raise AssertionError(f"{tag}: disagrees with its plain version "
                                 "or is not deterministic")
        if device.type == "cuda" and nbar != barrier_count(tk, ik):
            raise AssertionError(f"{tag}: {nbar} barriers, the rule says "
                                 f"{barrier_count(tk, ik)}")
        err_max = max(err_max, err, err_c)
    if not timed:
        return dict(max_abs_err=err_max)
    ms = timed_ms(lambda: launch.solve(*args), device, 20)
    pms = timed_ms(lambda: launch.plain(*args), device, 1)
    io, ops, stream = tree_cg_work(model, ik)
    b6 = bound(io, ops)
    # bench/roofline.py's count of the same solve: every iteration's
    # vectors and coefficients streamed through memory, set-up included
    counted = solver_traffic_bytes(model, ik)["bytes_total"]
    grid = launch.grid if device.type == "cuda" else 0
    L = len(tk.windowed)
    fac_bar = barrier_count(tk, 0) - 1 - (2 * L - 1)
    log(f"K6 time call {ms:.4f} ms a solve ({ik} iterations; plain "
        f"{pms:.4f} ms, bound {b6[0]:.6f} ms by {b6[1]}: {io:,} B of "
        f"inputs and tables ({bound(io, 0)[0]:.6f} ms), {ops:,} op "
        f"({bound(0, ops)[0]:.6f} ms); streaming every phase's {stream:,} "
        f"B from memory {bound(stream, 0)[0]:.6f} ms; bench/roofline.py's "
        f"{counted:,} B {bound(counted, 0)[0]:.6f} ms); grid {grid} blocks, "
        f"{barrier_count(tk, ik)} barriers a solve, {fac_bar} of them to "
        f"factor {L} levels")
    if all(tk.windowed) and fac_bar > 3 * L:
        raise AssertionError("K6: more than 3 barriers a windowed level")
    row = dict(name="tree_cg", route="cuda",
               source="mycelium_tpu_torch/kernels/csrc/tree_cg.cu",
               replaces="mycelium_tpu/fea/pallas_tree.py:397",
               max_abs_err=err_max, ms=ms, plain_ms=pms, bound_ms=b6[0],
               bound_by=b6[1], library_ms=None,
               stream_bound_ms=bound(stream, 0)[0],
               roofline_bound_ms=bound(counted, 0)[0],
               barriers=barrier_count(tk, ik), grid=grid)
    defer_device_ms(f"K6 {size}", row, lambda: launch.solve(*args), 20)

    def breakdown(device):
        """Where the launch's time goes (the iteration cap at 0 leaves the
        set-up, the factorization and one preconditioner apply), and the
        device operations and host syncs of one solve on the route."""
        cap = [device_ms(lambda: launch.solve(*args[:-1], c), device, 20)
               for c in (0, 1)]
        setup = device_ms(lambda: launch.setup(*args[:5], args[7]), device,
                          20)
        log(f"K6 {size} device time by iteration cap: 0 (set-up, "
            f"factorization, one apply) {cap[0]:.4f} ms, 1 {cap[1]:.4f} ms, "
            f"converged ({ik}) {row['device_ms']:.4f} ms; the set-up phase "
            f"as a kernel of its own {setup:.4f} ms")
        foot = solve_footprint(lambda: cold_once(model, cfg, args), device,
                               f"K6 solve {size}")
        row.update(device_ms_cap0=cap[0], device_ms_cap1=cap[1],
                   setup_device_ms=setup,
                   solve_device_ops=foot["device_ops"],
                   solve_host_syncs=foot["host_syncs"])
        if foot["device_ops"] > K6_MAX_DEVICE_OPS or \
                foot["host_syncs"] > K6_MAX_HOST_SYNCS:
            raise AssertionError(f"K6 solve: {foot} exceeds "
                                 f"{K6_MAX_DEVICE_OPS} device operations or "
                                 f"{K6_MAX_HOST_SYNCS} host sync")

    defer(breakdown)
    return row


def cold_once(model, cfg, args):
    """One ``solve_displacement`` on the K6 route with the masks of
    ``args`` (a ``solve_args`` tuple): what a ramp step calls."""
    from mycelium_tpu_torch.fea import solve_displacement
    active, free, dy_top, dy_bot, x0 = args[:5]
    return solve_displacement(model, active, dy_top, dy_bot, x0, cfg, free)


def route_compare(model, coords, conn, cfg, device, label: str) -> dict:
    """Phase 6: the same cold cg + tree solve through K6 and through the
    hybrid, in turns within this call: median of 5 each, coarse weight 0
    on both sides so both run the forest preconditioner alone."""
    from mycelium_tpu_torch.fea.model import (TREE_KERNEL_MAX_BYTES,
                                              tree_kernel_bytes)
    cfg0 = dataclasses.replace(cfg, tree_coarse_weight=0.0, warm_start=False)
    nb = tree_kernel_bytes(model)
    log(f"{label}: K6 would touch {nb / 1e6:.3f} MB (memory guard "
        f"{TREE_KERNEL_MAX_BYTES / 1e6:.0f} MB): route "
        f"{'tree_cg' if model.tree_kernel else 'hybrid'}")
    out = dict(kernel_bytes=nb, can_run_k6=bool(model.tree_kernel))
    for name, on, limit in (("k6", True, K6_LIMIT),
                            ("hybrid", False, STALL_LIMIT)):
        m = dataclasses.replace(model, tree_kernel=on)
        out[f"{name}_ms"], out[f"{name}_iters"] = cold_solve(
            m, coords, conn, cfg0, device, f"{label} cold solve, {name}", 5,
            limit=limit)
    return out


def compare_chain_cg_main(model, conn, cfg, device) -> float:
    """K5 at the shapes of the sweep path's largest solve (the 309k mesh:
    more clusters than resident blocks, so a block takes several, and the
    Gauss-Jordan inverse at its full size), on that solve's own inputs
    (intact, the islands pinned, cold) against its plain version on the
    CPU: ``k5_against_cpu``. Returns the largest error of x."""
    import torch
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    from mycelium_tpu_torch.kernels.chain_cg import layout_of
    active_np = np.ones(model.n_elems, bool)
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), active_np,
                                              grip), device=device)
    active = torch.as_tensor(active_np, device=device)
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=device)
    dy = cfg.displacement_max
    nbc, width, _ = layout_of(model.n_nodes, cfg)
    tag = (f"K5 chain_cg {model.n_dof} DOF ({nbc} clusters of {width} on "
           f"{k5_grid(model, cfg, device)} blocks)")
    return k5_against_cpu(model.chain_launch, model.chain_launch.on("cpu"),
                          (active, anch, dy, -dy, x0), cfg, tag)


def k5_grid(model, cfg, device) -> int:
    """Blocks of K5's cooperative grid for ``model`` under ``cfg``: one a
    cluster, at most as many as the card holds at once."""
    if device.type != "cuda":
        return 0
    from mycelium_tpu_torch.kernels.chain_cg import layout_of, resident_blocks
    return min(layout_of(model.n_nodes, cfg)[0],
               resident_blocks(device.index or 0))


def k5_footprint(model, coords, conn, device, out: dict) -> None:
    """In the traced tail: the device operations and host syncs of one
    cold cg + coarse ``solve_displacement`` at 22k (at most
    K5_MAX_DEVICE_OPS and K5_MAX_HOST_SYNCS), and two models built afresh
    from the same mesh, which must give the same iterations and the same x
    bit for bit (the set-up adds in a fixed order: no float atomics)."""
    import torch
    from mycelium_tpu_torch.config import hybrid_fea_config
    from mycelium_tpu_torch.fea import build_model, solve_displacement
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    cfg = k5_config()
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    active_np = np.ones(model.n_elems, bool)
    anch = torch.as_tensor(anchored_mask_host(np.asarray(conn), active_np,
                                              grip), device=device)
    active = torch.as_tensor(active_np, device=device)
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=device)
    dy = cfg.displacement_max
    foot = solve_footprint(lambda: solve_displacement(
        model, active, dy, -dy, x0, cfg, anch), device,
        "K5 cg+coarse solve 22k")
    fresh = []
    for _ in range(2):
        m = build_model(coords, conn, hybrid_fea_config(warm_start=False),
                        device)
        res = solve_displacement(m, active, dy, -dy, x0, cfg, anch)
        fresh.append((res.iters, res.x.clone()))
    same = fresh[0][0] == fresh[1][0] and torch.equal(fresh[0][1],
                                                      fresh[1][1])
    log(f"K5 two fresh model builds: iterations {fresh[0][0]}, "
        f"{fresh[1][0]}; x bit-equal: {same}")
    out.update(k5_solve_device_ops=foot["device_ops"],
               k5_solve_host_syncs=foot["host_syncs"],
               k5_fresh_iters=[fresh[0][0], fresh[1][0]],
               k5_fresh_bit_equal=same)
    if foot["device_ops"] > K5_MAX_DEVICE_OPS or \
            foot["host_syncs"] > K5_MAX_HOST_SYNCS:
        raise AssertionError(f"K5 solve: {foot} exceeds {K5_MAX_DEVICE_OPS} "
                             f"device operations or {K5_MAX_HOST_SYNCS} host "
                             "sync")
    if not same:
        raise AssertionError("K5: two fresh model builds solve apart")


def sweep_path(model, coords, conn, model_b, coords_b, conn_b, grip_b,
               device) -> dict:
    """Phase 8: cg + coarse cold solves through K5 (22,125 DOF: median of
    5 with the float64 residual check, beside the same solve on the eager
    chain path; 309k DOF: one, converged within max_iter 3000), then the
    15-combination sweep on the 22,125-DOF mesh in the configuration of
    scripts/bench_sweep_tpu.py (rtol 1e-5, max_iter 3000, tree legs with
    coarse weight 0.25), SWEEP_STEPS ramp steps, one trial each. cg + tree,
    cg + coarse, bicgstab + tree and gmres + tree must converge at every
    step. The cg + tree leg and the physics solve run K6 (no coarse stage),
    as the JAX package at this size runs its whole-solve tree kernel; the
    other tree legs run the hybrid (K1-K3 and the coarse weight)."""
    import tempfile
    from mycelium_tpu_torch.bench import run_solver_sweep
    from mycelium_tpu_torch.config import FeaConfig
    from mycelium_tpu_torch.fea.hybrid import chain_path_solve
    out = {}
    out["k5_ms_22k"], out["k5_iters_22k"] = cold_solve(
        model, coords, conn, k5_config(), device,
        "K5 cg+coarse cold solve 22k", 5, limit=K5_LIMIT)
    defer(lambda dev: k5_footprint(model, coords, conn, dev, out))
    # the same solve on the eager chain path (K1 operator, the
    # preconditioner in PyTorch ops, one host read an iteration; its stall
    # exit may stop it within 10x the tolerance)
    out["eager_ms_22k"], out["eager_iters_22k"] = cold_solve(
        model, coords, conn, k5_config(), device,
        "eager chain cg+coarse cold solve 22k", 3,
        limit=10.0 * SWEEP_RTOL + F32_MARGIN, route=chain_path_solve)
    out["k5_ms_309k"], out["k5_iters_309k"] = cold_solve(
        model_b, coords_b, conn_b, k5_config(grip_length=grip_b), device,
        "K5 cg+coarse cold solve 309k", 1, limit=K5_LIMIT)
    cfg = FeaConfig(dtype="float32", rtol=SWEEP_RTOL,
                    max_iter=SWEEP_MAX_ITER, operator="chain",
                    precond="tree", tree_coarse_weight=0.25,
                    tree_reg_rel=1e-7, n_steps=SWEEP_STEPS)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        csv = os.path.join(tmp, "runtime_results.csv")
        rows, meta = run_solver_sweep(coords, conn, cfg, trials=1,
                                      out_csv=csv, return_meta=True,
                                      device=device)
        with open(csv) as f:
            header, n_lines = f.readline().strip(), sum(1 for _ in f)
        has_meta = os.path.exists(os.path.join(tmp,
                                               "runtime_results_meta.json"))
    wall = time.perf_counter() - t0
    log(f"sweep: {3 * coords.shape[0]} DOF, {SWEEP_STEPS} steps, "
        f"{len(rows)} rows in {wall:.2f} s; csv header {header!r}, "
        f"{n_lines} rows, sidecar {has_meta}")
    if header != "step,solver,pc,trial,runtime_ms,pc_ref" or \
            n_lines != len(rows) or len(rows) != 15 * SWEEP_STEPS \
            or not has_meta:
        raise AssertionError("sweep: CSV or sidecar malformed")
    combos = {}
    for key, st in meta["combos"].items():
        ms = [r[4] for r in rows if f"{r[1]}+{r[2]}" == key and r[0] > 0]
        combos[key] = dict(median_ms=float(np.median(ms)),
                           route=st["route"],
                           median_iters=st["median_iters"],
                           max_iters=st["max_iters"],
                           converged_steps=st["converged_steps"],
                           steps=st["steps"])
        log(f"sweep {key} ({st['route']}): median "
            f"{combos[key]['median_ms']:.3f} ms over "
            f"the loaded steps, iterations median {st['median_iters']} max "
            f"{st['max_iters']}, converged {st['converged_steps']}/"
            f"{st['steps']} steps")
    must = ("cg+tree", "cg+coarse", "bicgstab+tree", "gmres+tree")
    bad = [k for k in must
           if combos[k]["converged_steps"] != combos[k]["steps"]]
    if bad:
        raise AssertionError(f"sweep legs did not converge: {bad}")
    want = "tree_cg" if model.tree_kernel else "hybrid"
    if combos["cg+tree"]["route"] != want:
        raise AssertionError(f"sweep cg+tree took the route "
                             f"{combos['cg+tree']['route']}, not {want}")
    out["sweep"] = combos
    out["sweep_wall_s"] = wall
    return out


def coupled_pipeline(preset: str, device, fea_steps: int = 40) -> dict:
    """Phase 12: grow -> mesh -> model on the card -> cold solve (float64
    residual check) -> ramp, with each stage's wall time, on the solver
    configuration of mycelium_tpu/bench/coupled.py."""
    from mycelium_tpu_torch.config import GROWTH_PRESETS, tuned_fea_config
    from mycelium_tpu_torch.fea import run_ramp
    from mycelium_tpu_torch.growth import run_growth, state_mesh
    t = {}
    t0 = time.perf_counter()
    st, _, hist = run_growth(GROWTH_PRESETS[preset], device=device)
    sync(device)
    t["growth_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    coords, conn = state_mesh(st)
    t["mesh_s"] = time.perf_counter() - t0
    cfg = tuned_fea_config(n_steps=fea_steps, rtol=RTOL)
    t0 = time.perf_counter()
    model = timed_build(coords, conn, cfg, device, f"coupled {preset}")
    t["build_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    from mycelium_tpu_torch.fea.model import tree_kernel_bytes
    route = "tree_cg" if model.tree_kernel else "hybrid"
    log(f"coupled {preset}: K6 would touch "
        f"{tree_kernel_bytes(model) / 1e6:.3f} MB: route {route}")
    ms, iters = cold_solve(model, coords, conn,
                              dataclasses.replace(cfg, warm_start=False),
                              device, f"coupled {preset} cold solve", 3,
                              limit=K6_LIMIT if model.tree_kernel
                              else STALL_LIMIT)
    t["cold_solve_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = run_ramp(coords, conn, cfg, model=model)
    sync(device)
    t["ramp_s"] = time.perf_counter() - t0
    n_rec = int(res.force_disp.shape[0])
    fractured = int((~res.active_record[-1]).sum())
    log(f"coupled {preset}: {hist[-1]['segments']} segments -> "
        f"{coords.shape[0]} nodes, {model.n_dof} DOF; cold solve "
        f"{iters} iterations, median {ms:.3f} ms; ramp {n_rec} steps "
        f"recorded, {int(res.cg_iters.sum())} CG iterations, {fractured} "
        f"elements fractured; stage wall times "
        + ", ".join(f"{k} {v:.3f}" for k, v in t.items()))
    if n_rec < 2:
        raise AssertionError(f"coupled {preset}: ramp recorded {n_rec}")
    return dict(segments=hist[-1]["segments"], dof=model.n_dof, route=route,
                cold_iters=iters, cold_ms=ms, ramp_steps=n_rec,
                ramp_iters=int(res.cg_iters.sum()), fractured=fractured,
                **t)


class _Interrupted(Exception):
    """Stands for a run killed between two ramp steps."""


@contextlib.contextmanager
def interrupted_after(n_steps: int):
    """Let ``run_ramp`` take ``n_steps`` steps, then stop it before the
    next one, as a job cut by its time limit: what it checkpointed by then
    is on disk."""
    from mycelium_tpu_torch.fea import ramp
    real, calls = ramp.ramp_step, [0]

    def step(*args, **kw):
        calls[0] += 1
        if calls[0] > n_steps:
            raise _Interrupted
        return real(*args, **kw)

    ramp.ramp_step = step
    try:
        yield
    except _Interrupted:
        pass
    finally:
        ramp.ramp_step = real


def ramp_records_equal(a, b) -> list:
    """The names of the records in which two ramp results differ."""
    return [f for f in ("stress_record", "active_record", "disp_record",
                        "force_disp", "cg_iters")
            if not np.array_equal(getattr(a, f), getattr(b, f))]


def ramp_checkpoint_check(coords, conn, cfg, model, device, loop, tmp,
                          split: int = 20) -> dict:
    """Phase 13, the ramp half: the ramp of ``ramp_check`` (``loop``, on
    the route of ``model``) run for ``split`` steps with
    ``checkpoint_every=split`` and stopped, then resumed from the file:
    every record bit for bit the unsplit run's. Then a float32 run of the
    same ramp on the CPU (K6's plain version), stopped after ``split``
    steps, resumed on the card: every step within 1e-3 of the card's
    unsplit run (displacement rel L2 and force), as ``ramp_check`` holds
    the card to the CPU path. The file's save and load times and size."""
    from mycelium_tpu_torch.fea import build_model, run_ramp
    from mycelium_tpu_torch.io.checkpoint import (load_ramp_state,
                                                  save_ramp_state)
    path = os.path.join(tmp, "fea_checkpoint.npz")
    with interrupted_after(split):
        run_ramp(coords, conn, cfg, model=model, checkpoint_path=path,
                 checkpoint_every=split)
    t0 = time.perf_counter()
    state = load_ramp_state(path)
    load_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    save_ramp_state(os.path.join(tmp, "again.npz"), *state)
    save_ms = (time.perf_counter() - t0) * 1e3
    size = os.path.getsize(path)
    if state[0] != split:
        raise AssertionError(f"ramp checkpoint at step {state[0]}, not "
                             f"{split}")
    t0 = time.perf_counter()
    res = run_ramp(coords, conn, cfg, model=model, resume_from=path)
    sync(device)
    resume_s = time.perf_counter() - t0
    bad = ramp_records_equal(res, loop)
    log(f"ramp checkpoint {model.n_dof} DOF: stopped after {split} steps, "
        f"resumed to step {res.force_disp.shape[0]} in {resume_s:.3f} s; "
        f"every record equal to the unsplit run: {not bad} {bad}; the file "
        f"{size} bytes, save {save_ms:.3f} ms, load {load_ms:.3f} ms")
    if bad:
        raise AssertionError(f"resumed ramp differs from the unsplit run: "
                             f"{bad}")
    cpu_path = os.path.join(tmp, "fea_checkpoint_cpu.npz")
    t0 = time.perf_counter()
    cpu = build_model(coords, conn, cfg, "cpu")
    with interrupted_after(split):
        run_ramp(coords, conn, cfg, model=cpu, checkpoint_path=cpu_path,
                 checkpoint_every=split)
    cpu_s = time.perf_counter() - t0
    mixed = run_ramp(coords, conn, cfg, model=model, resume_from=cpu_path)
    worst_u = worst_f = 0.0
    for step in range(1, loop.force_disp.shape[0]):
        ref = loop.disp_record[step]
        worst_u = max(worst_u, float(
            np.linalg.norm(mixed.disp_record[step] - ref)
            / max(np.linalg.norm(ref), 1e-300)))
        f = loop.force_disp[step, 1]
        worst_f = max(worst_f, abs(mixed.force_disp[step, 1] - f)
                      / max(abs(f), 1e-300))
    same_shape = mixed.force_disp.shape == loop.force_disp.shape
    same_active = same_shape and np.array_equal(mixed.active_record,
                                                 loop.active_record)
    log(f"ramp checkpoint written on the CPU after {split} steps ("
        f"{cpu_s:.2f} s there), resumed on the card: "
        f"{mixed.force_disp.shape[0]} steps, displacement rel L2 "
        f"{worst_u:.3e}, force rel {worst_f:.3e} from the card's unsplit "
        f"run (tol 1e-3), active records equal {same_active}")
    if not (same_shape and worst_u <= 1e-3 and worst_f <= 1e-3):
        raise AssertionError("the ramp resumed from the CPU's checkpoint "
                             "disagrees with the card's run")
    return dict(split=split, file_bytes=size, save_ms=save_ms,
                load_ms=load_ms, resume_s=resume_s, cpu_file_disp=worst_u,
                cpu_file_force=worst_f)


def growth_checkpoint_check(preset: str, device, tmp) -> dict:
    """Phase 13, the growth half: the preset grown unsplit, and split at
    half its steps by a checkpoint and resumed through K4: every state
    field, the anastomosis grid and the stats equal bit for bit."""
    import torch
    from mycelium_tpu_torch.config import GROWTH_PRESETS
    from mycelium_tpu_torch.growth import run_growth
    from mycelium_tpu_torch.io.checkpoint import (GROWTH_FIELDS,
                                                  load_growth_state)
    cfg = GROWTH_PRESETS[preset]
    half = cfg.t_steps // 2
    path = os.path.join(tmp, "growth_checkpoint.npz")
    full, _, hist = run_growth(cfg, device=device)
    run_growth(dataclasses.replace(cfg, t_steps=half), device=device,
               checkpoint_path=path, checkpoint_every=half)
    t0 = time.perf_counter()
    st, draws = load_growth_state(path, cfg, device)
    load_ms = (time.perf_counter() - t0) * 1e3
    res, _, hist_r = run_growth(cfg, device=device, initial_state=st,
                                draws=draws)
    sync(device)
    bad = [k for k in GROWTH_FIELDS
           if not (torch.equal(getattr(res, k), getattr(full, k))
                   if torch.is_tensor(getattr(res, k))
                   else getattr(res, k) == getattr(full, k))]
    bad += [f"grid.{k}" for k in ("ids", "geo", "count")
            if not torch.equal(getattr(res.grid, k), getattr(full.grid, k))]
    if hist_r != hist[half:]:
        bad.append("history")
    log(f"growth checkpoint {preset}: split at step {half} of "
        f"{cfg.t_steps}, resumed: every field, the grid and the stats "
        f"equal to the unsplit run: {not bad} {bad}; {full.n_seg} segments, "
        f"{hist[-1]['anastomosed']} anastomosed; the file "
        f"{os.path.getsize(path)} bytes, load {load_ms:.3f} ms")
    if bad:
        raise AssertionError(f"resumed growth differs: {bad}")
    return dict(split=half, steps=cfg.t_steps,
                file_bytes=os.path.getsize(path))


def cold_inputs(model, conn, cfg, device) -> tuple:
    """(active, anchored, x0, dy) of a cold solve of the intact system with
    its grip-unreachable islands pinned, as ``cold_solve`` sets it up."""
    import torch
    from mycelium_tpu_torch.fea.ramp import anchored_mask_host
    grip = (model.top_nodes | model.bot_nodes).cpu().numpy()
    anch = torch.as_tensor(anchored_mask_host(
        np.asarray(conn), np.ones(model.n_elems, bool), grip), device=device)
    active = torch.ones(model.n_elems, dtype=torch.bool, device=device)
    x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=device)
    return active, anch, x0, cfg.displacement_max


def single_reference(single, conn, cfg, device) -> tuple:
    """(x, iterations) of the single-device cold solve of ``single``
    (a copy: a K5 or K6 result is a launch buffer)."""
    from mycelium_tpu_torch.fea import solve_displacement
    active, anch, x0, dy = cold_inputs(single, conn, cfg, device)
    ref = solve_displacement(single, active, dy, -dy, x0, cfg, anch)
    if not ref.converged:
        raise AssertionError("the single-device reference did not converge")
    return ref.x.clone(), ref.iters


def sharded_solve_check(model, ref, coords, conn, cfg, device, label: str,
                        rel_slack: float, limit: float) -> dict:
    """Phase 14, one system: the sharded solve over the one-rank group
    (``fea/shard.py``) against ``ref`` (``single_reference`` of the same
    system): relative max error at most 1e-3 of max |x|, iterations within
    max(1, rel_slack x the reference's); then its cold solves timed with
    the float64 residual check (bound ``limit``), and, in the traced tail,
    its device operations, host syncs and the NCCL kernels' device
    time."""
    import torch
    from mycelium_tpu_torch.fea.shard import sharded_cg_solver
    ref_x, ref_iters = ref
    active, anch, x0, dy = cold_inputs(model, conn, cfg, device)
    solver = sharded_cg_solver(model, cfg)
    res = solver(active, dy, -dy, x0, anch)
    _, err = rel_err([res.x], [ref_x])
    slack = max(1, int(rel_slack * ref_iters))
    log(f"{label}: sharded {res.iters} iterations (converged "
        f"{res.converged}), single device {ref_iters} (slack {slack}); "
        f"relative max error {err:.3e} (tol 1e-3)")
    if not (res.converged and err <= 1e-3
            and abs(res.iters - ref_iters) <= slack):
        raise AssertionError(f"{label}: the sharded solve disagrees with "
                             f"the single-device solve (err {err:.3e}, "
                             f"{res.iters} against {ref_iters} iterations)")
    ms, iters = cold_solve(model, coords, conn, cfg, device,
                           f"{label}, sharded cold solve", 5, limit=limit,
                           route=lambda m, a, dt, db, x, c, an:
                           solver(a, dt, db, x, an))
    # the element operator alone (all_gather, element forces, the node
    # sums through ordered_sum, reduce_scatter) beside K1's reading
    u_l = solver.local(torch.randn((model.n_nodes, 3), dtype=model.dtype,
                                   device=device,
                                   generator=torch.Generator(device)
                                   .manual_seed(0)))
    act_l = solver.local_active(active)
    op_ms = timed_ms(lambda: solver.stiffness(u_l, act_l), device, 20)
    log(f"{label}: the element operator (all_gather, forces, ordered_sum, "
        f"reduce_scatter) {op_ms:.4f} ms a call")
    row = dict(ms=ms, iters=iters, single_iters=ref_iters, max_rel_err=err,
               operator_ms=op_ms)

    def solve():
        return solver(active, dy, -dy, x0, anch)

    def read(device):
        row.update(solve_footprint(solve, device, f"{label}, sharded"))
        nccl = 0.0
        if device.type == "cuda":
            from torch.profiler import ProfilerActivity, profile
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    solve()
                torch.cuda.synchronize()
            nccl = sum(e.device_time for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "nccl" in e.name.lower()) / 1e3 / 3
        row["nccl_device_ms"] = nccl
        log(f"{label}, sharded: NCCL kernels {nccl:.4f} ms of device time "
            "a solve")

    defer(read)
    return row


def sharded_ramp_check(coords, conn, cfg, model, device, loop,
                       loop_s: float) -> dict:
    """Phase 14, the ramp: ``run_ramp_sharded`` over the one-rank group
    against ``loop``, ``run_ramp`` of the same model forced onto the
    hybrid: every step converges (the drivers raise otherwise), equal
    active records, forces within 1e-3 relative of the largest."""
    from mycelium_tpu_torch.fea import run_ramp_sharded
    t0 = time.perf_counter()
    res = run_ramp_sharded(coords, conn, cfg, model=model)
    sync(device)
    wall = time.perf_counter() - t0
    same = res.active_record.shape == loop.active_record.shape and \
        np.array_equal(res.active_record, loop.active_record)
    fs = max(np.abs(loop.force_disp[:, 1]).max(), 1e-300)
    df = float(np.abs(res.force_disp[:, 1] - loop.force_disp[:, 1]).max()
               / fs) if same else float("inf")
    log(f"sharded ramp {model.n_dof} DOF: {res.force_disp.shape[0]} steps "
        f"in {wall:.3f} s ({int(res.cg_iters.sum())} CG iterations; "
        f"run_ramp on the hybrid {loop_s:.3f} s, "
        f"{int(loop.cg_iters.sum())}), "
        f"{int((~res.active_record[-1]).sum())} elements fractured, active "
        f"records equal {same}, force rel {df:.3e} (tol 1e-3)")
    if not (same and df <= 1e-3
            and res.force_disp.shape[0] == cfg.n_steps):
        raise AssertionError("the sharded ramp disagrees with run_ramp")
    return dict(steps=int(res.force_disp.shape[0]), wall_s=wall,
                loop_s=loop_s, iters=int(res.cg_iters.sum()),
                loop_iters=int(loop.cg_iters.sum()), force_rel=df)


def sharded_path(model, coords, conn, cfg, model_b, coords_b, conn_b,
                 cfg_b, grip_b, device) -> tuple:
    """Phase 14: a one-rank process group (NCCL on the card, over a
    ``file://`` store), the references on one device first, then, with the
    launch counts set to 0, the sharded tree solves at both sizes (K2, K3,
    ``ordered_sum``), the sharded coarse solve at the small size against
    K5 (iterations within 2%), and the 40-step sharded ramp at the large
    size. Returns the readings and the sharded path's launch counts."""
    import torch.distributed as dist
    from mycelium_tpu_torch.config import hybrid_fea_config
    from mycelium_tpu_torch.fea import run_ramp
    from mycelium_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mycelium_tpu_torch.utils.dist import initialize_single
    t0 = time.perf_counter()
    initialize_single(device)
    log(f"one-rank process group, {dist.get_backend()}, in "
        f"{time.perf_counter() - t0:.2f} s")
    hyb, hyb_b = (dataclasses.replace(m, tree_kernel=False)
                  for m in (model, model_b))
    kcfg = k5_config()
    ramp_b = hybrid_fea_config(grip_length=grip_b, tree_coarse_weight=0.25)
    refs = {"tree_22k": single_reference(hyb, conn, cfg, device),
            "tree_309k": single_reference(hyb_b, conn_b, cfg_b, device),
            "coarse_22k": single_reference(model, conn, kcfg, device)}
    t0 = time.perf_counter()
    loop = run_ramp(coords_b, conn_b, ramp_b, model=hyb_b)
    sync(device)
    loop_s = time.perf_counter() - t0
    reset_launch_counts()
    out = {
        "tree_22k": sharded_solve_check(
            hyb, refs["tree_22k"], coords, conn, cfg, device,
            f"sharded tree {model.n_dof} DOF", 0.0, STALL_LIMIT),
        "tree_309k": sharded_solve_check(
            hyb_b, refs["tree_309k"], coords_b, conn_b, cfg_b, device,
            f"sharded tree {model_b.n_dof} DOF, coarse weight "
            f"{cfg_b.tree_coarse_weight}", 0.0, STALL_LIMIT),
        "coarse_22k": sharded_solve_check(
            model, refs["coarse_22k"], coords, conn, kcfg, device,
            f"sharded coarse {model.n_dof} DOF against K5", 0.02,
            10.0 * SWEEP_RTOL + F32_MARGIN),
        "ramp_309k": sharded_ramp_check(coords_b, conn_b, ramp_b, hyb_b,
                                        device, loop, loop_s)}
    sync(device)
    return out, launch_counts()


def dof_label(n_dof: int) -> str:
    """A system's size as K6_TOL names it: 22k, 309k, 1.02M, 3M."""
    return f"{n_dof / 1e6:.3g}M" if n_dof >= 10 ** 6 else f"{n_dof // 1000}k"


def scaling_path(device, sizes, rng) -> tuple:
    """Phase 16, the scaling path: ``bench.scaling`` at each size, the
    launch counts set to 0 before each size and read after. A size on the
    route ``tree_cg`` must launch K6, one on the hybrid K1-K3; its last
    solve's float64 residual, by the port's ``assemble_scipy``, within
    K6_LIMIT (STALL_LIMIT on the hybrid); ``bytes_total`` positive and
    finite, ``cg_iters`` at least 1. After each size on K6, K6 against
    its plain version at that size's shapes (``compare_tree_cg``: on the
    card and on the CPU, its set-up, one apply, iterations and result),
    its launches not counted. Returns (a summary, the phase's counts)."""
    import math
    from mycelium_tpu_torch.bench.scaling import DY, scaling_size
    from mycelium_tpu_torch.kernels import launch_counts, reset_launch_counts
    from mycelium_tpu_torch.meshes import synthetic_mesh
    t_phase = time.perf_counter()
    rows, total, k6_err, compare_s = [], None, 0.0, 0.0
    for n in sizes:
        t0 = time.perf_counter()
        coords, conn = synthetic_mesh(n)
        mesh_s = time.perf_counter() - t0
        reset_launch_counts()
        row, s = scaling_size(coords, conn, device=device)
        sync(device)
        counts = launch_counts()
        total = counts if total is None else {
            k: v + counts[k] for k, v in total.items()}
        route = row["route"]
        t1 = time.perf_counter()
        rel = residual_check(s.model, coords, conn, s.cfg,
                             s.x.double().cpu().numpy(), DY,
                             s.active.cpu().numpy(), s.anchored.cpu().numpy())
        check_s = time.perf_counter() - t1
        need = ("tree_cg",) if route == "tree_cg" else (
            "chain_matvec", "pcr_factor", "pcr_apply")
        limit = K6_LIMIT if route == "tree_cg" else STALL_LIMIT
        log(f"scaling {n} nodes: {json.dumps(row)}")
        log(f"scaling {row['n_dof']} DOF: route {route}, launches "
            f"{ {k: v for k, v in counts.items() if v} }; float64 residual "
            f"{rel:.3e} (bound {limit:.1e}); mesh {mesh_s:.2f} s, plan "
            f"build {row['plan_build_s']:.2f} s, size "
            f"{t1 - t0:.2f} s, residual check {check_s:.2f} s")
        missing = [k for k in need if counts[k] < 1]
        if device.type == "cuda" and missing:
            raise AssertionError(f"scaling {row['n_dof']} DOF on route "
                                 f"{route}: {missing} never launched")
        if not rel <= limit:
            raise AssertionError(f"scaling {row['n_dof']} DOF: float64 "
                                 f"residual {rel:.3e} > {limit:.1e}")
        if not (row["bytes_total"] > 0 and math.isfinite(row["bytes_total"])
                and row["cg_iters"] >= 1):
            raise AssertionError(f"scaling {row['n_dof']} DOF: bytes_total "
                                 f"{row['bytes_total']}, cg_iters "
                                 f"{row['cg_iters']}")
        if route == "tree_cg":
            t1 = time.perf_counter()
            k6_err = max(k6_err, compare_tree_cg(
                s.model, conn, s.cfg, device, rng, dof_label(row["n_dof"]),
                False)["max_abs_err"])
            compare_s += time.perf_counter() - t1
            log(f"scaling {row['n_dof']} DOF: K6 against its plain version "
                f"{time.perf_counter() - t1:.2f} s")
        rows.append(dict(row, residual=rel, mesh_s=mesh_s,
                         launches={k: v for k, v in counts.items() if v}))
        del s
    sync(device)
    wall = time.perf_counter() - t_phase
    log(f"kernel launches on the scaling path: {total} (phase wall "
        f"{wall:.2f} s, {compare_s:.2f} s of it K6 against its plain "
        "version)")
    return dict(rows=rows, wall_s=wall, k6_compare_s=compare_s,
                k6_max_abs_err=k6_err), total


# run_ramp_async's status read: every 8 steps (its sync_every default)
RAMP_SYNC_EVERY = 8


def ramp_solves(res, n_steps: int) -> int:
    """The solves ``fea/ramp.py::_loop`` issued for the ramp ``res`` of
    ``run_ramp_async``: every step unless the network fractured through.
    Then its records end at the step that broke the last element, but the
    ramp solved on to its next status read (a multiple of RAMP_SYNC_EVERY
    steps, at most n_steps), so a truncated ramp may still have solved
    every step."""
    n_rec = res.force_disp.shape[0]
    if res.active_record[-1].any():
        return n_steps
    return min(n_steps, -(-n_rec // RAMP_SYNC_EVERY) * RAMP_SYNC_EVERY)


def ramp_refreshes(res) -> int:
    """The grip-reachability refreshes of a ramp: one at its start and one
    after each step whose active mask differs from the step before."""
    prev = np.ones(res.active_record.shape[1], bool)
    n = 1
    for act in res.active_record:
        n += int(not np.array_equal(act, prev))
        prev = act
    return n


def ramp_solve_ms(model, cfg, res, device) -> list:
    """Milliseconds of each recorded step's solve of the ramp ``res``,
    replayed on its own inputs: the step's active mask (the step before's
    record), its grip reachability and its warm start (the step before's
    displacement scaled as the ramp scales it), timed with CUDA events
    (the mean of 3 calls after one)."""
    import torch
    from mycelium_tpu_torch.fea.ramp import refresh_anchored
    from mycelium_tpu_torch.fea.solve import solve_displacement
    out, act_np = [], None
    for step in range(res.force_disp.shape[0]):
        prev = np.ones(model.n_elems, bool) if step == 0 \
            else res.active_record[step - 1]
        if act_np is None or not np.array_equal(prev, act_np):
            act_np = prev
            act = torch.as_tensor(act_np, device=device)
            anch = refresh_anchored(model, act)
        dy = cfg.displacement_max * step / (cfg.n_steps - 1)
        if cfg.warm_start and step > 1:
            x0 = torch.as_tensor(res.disp_record[step - 1].reshape(-1, 3)
                                 * (step / (step - 1)), device=device)
        else:
            x0 = torch.zeros((model.n_nodes, 3), dtype=model.dtype,
                             device=device)
        out.append(timed_ms(lambda: solve_displacement(
            model, act, dy, -dy, x0, cfg, anch), device, 3))
    return out


def headline_path(device, n_small: int, n_big: int) -> tuple:
    """Phase 17, the headline: ``bench/headline.py::run`` on meshes of
    ``n_small`` and ``n_big`` nodes (its defaults in the card run: the 22k
    cold-solve median, the 309k cold solve and the 309k 40-step ramp), the
    launch counts set to 0 before and read after. Checks: both
    solves on the route ``tree_cg`` and the ramp's model too; K6's launches
    equal what the loops imply (the 22k timing's warm-up and windows,
    ``scaling_size``'s at 309k, and each ramp's ``ramp_solves``); the 22k
    headline solve's float64 residual, by the port's ``assemble_scipy``,
    within K6_LIMIT; every ramp converged at every step (``run_ramp_async``
    raises on a step that did not) and recorded 1 to n_steps steps; every
    number of the row finite and positive. Then where the ramp's time goes,
    synchronised readings on the ramp's model: its recorded steps' solves
    (``ramp_solve_ms``), ``post_solve`` once a solve (K8 into one set of
    rows, as ``_DeviceRecords`` hands them), the reachability
    refreshes (timed on the last ramp's final mask) and the rest (record
    writes, flag reads, the records' fetch, solves past the records).
    Returns (a summary, the phase's counts)."""
    import math
    import torch
    from mycelium_tpu_torch.bench import headline, scaling
    from mycelium_tpu_torch.fea.ramp import post_solve, refresh_anchored
    from mycelium_tpu_torch.fea.solve import solve_route
    from mycelium_tpu_torch.kernels import launch_counts, reset_launch_counts
    if os.environ.pop(headline.SMALL_ENV, None) is not None:
        log(f"headline: {headline.SMALL_ENV} ignored, the phase runs every "
            "part")
    t0 = time.perf_counter()
    reset_launch_counts()
    h = headline.run(device, n_small, n_big)
    sync(device)
    counts = launch_counts()
    wall = time.perf_counter() - t0
    row, model, cfg = h.row, h.ramp_model, h.ramp_cfg
    log(f"headline: {json.dumps(row)}")
    routes = dict(route=row["route"], route_309k=row["route_309k"],
                  ramp_route_309k=solve_route(model, cfg))
    solves = [ramp_solves(r, cfg.n_steps) for r in h.ramps]
    want = (headline.WARM + headline.WINDOWS * headline.N_CHAIN
            + scaling.WARM_CALLS + scaling.WINDOWS * headline.BIG_CHAIN
            + sum(solves))
    steps = [int(r.force_disp.shape[0]) for r in h.ramps]
    s = h.solve
    rel = residual_check(s.model, h.coords, h.conn, s.cfg,
                         s.x.double().cpu().numpy(), s.cfg.displacement_max,
                         s.active.cpu().numpy(), s.anchored.cpu().numpy())
    others = {k: v for k, v in counts.items() if v and k != "tree_cg"}
    log(f"headline: routes {routes}; K6 launches {counts['tree_cg']} "
        f"(the loops imply {want}: 22k {headline.WARM} + "
        f"{headline.WINDOWS}x{headline.N_CHAIN}, 309k {scaling.WARM_CALLS} "
        f"+ {scaling.WINDOWS}x{headline.BIG_CHAIN}, ramps {solves}); other "
        f"launches {others}; ramp steps {steps}; 22k float64 residual "
        f"{rel:.3e} (bound {K6_LIMIT:.1e}); phase wall {wall:.2f} s")
    bad = [f"{k} {v}" for k, v in routes.items() if v != "tree_cg"]
    if device.type == "cuda" and counts["tree_cg"] != want:
        bad.append(f"K6 launched {counts['tree_cg']} times, not {want}")
    if not rel <= K6_LIMIT:
        bad.append(f"22k float64 residual {rel:.3e} > {K6_LIMIT:.1e}")
    if not all(1 <= n <= cfg.n_steps for n in steps) \
            or row["ramp_steps_309k"] != steps[-1]:
        bad.append(f"ramp steps {steps}, ramp_steps_309k "
                   f"{row['ramp_steps_309k']}")
    nums = {k: v for k, v in row.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)}
    bad += [f"{k} {v}" for k, v in nums.items()
            if not (math.isfinite(v) and v > 0)]
    if bad:
        raise AssertionError(f"headline: {bad}")

    # where the ramp's time goes
    last = h.ramps[-1]
    act = torch.ones(model.n_elems, dtype=torch.bool, device=device)
    final = torch.as_tensor(last.active_record[-1], device=device)
    u = torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=device)
    rows = model.post_launch.rows()
    post_ms = timed_ms(lambda: post_solve(model, cfg, u, act, rows), device,
                       10)
    refresh_ms = timed_ms(lambda: refresh_anchored(model, final), device, 5)
    n_refresh = ramp_refreshes(last)
    step_ms = ramp_solve_ms(model, cfg, last, device)
    parts = dict(solves=sum(step_ms) / 1e3,
                 post_solve=solves[-1] * post_ms / 1e3,
                 refreshes=n_refresh * refresh_ms / 1e3)
    parts["rest"] = h.ramp_s - sum(parts.values())
    split = dict(ramp_s=h.ramp_s, steps=steps[-1], solves=solves[-1],
                 refreshes=n_refresh, post_solve_ms=post_ms,
                 refresh_ms=refresh_ms,
                 fractured=int((~last.active_record[-1]).sum()),
                 cg_iters=last.cg_iters.tolist(), solve_ms=step_ms,
                 parts_s=parts)
    log(f"headline ramp split: {json.dumps(split)}")
    return dict(row=row, ms=h.ms, residual_22k=rel, wall_s=wall,
                k6_launches_implied=want, ramp=split), counts


def run(device, n_small: int = 7375, n_big: int = 103000,
        big_growth: str = "xlarge", growth_steps: int = GROWTH_STEPS,
        trajectory: str = "demo", coupled: str = "medium",
        n_mid: int = 33000, big_pcr_levels: int = 2,
        scaling_nodes=SCALING_NODES) -> dict:
    """Every phase; the defaults are the run on the card. A smaller run
    (a rehearsal on the CPU) names the hybrid's PCR levels on its
    ``n_big`` mesh in ``big_pcr_levels``: at 309k DOF there are 2, so
    P7's check there holds K2 on a level with Schur corrections."""
    import torch

    from mycelium_tpu_torch.config import (GROWTH_PRESETS, growth_3d_config,
                                           hybrid_fea_config)
    from mycelium_tpu_torch.kernels import build, launch_counts
    from mycelium_tpu_torch.kernels import reset_launch_counts
    from mycelium_tpu_torch.meshes import synthetic_mesh

    device = torch.device(device)
    rng = np.random.default_rng(0)
    t_start = time.perf_counter()
    if device.type == "cuda":
        t0 = time.perf_counter()
        path, secs = build.build()
        build.library()
        log(f"kernels built in {secs:.2f} s ({time.perf_counter() - t0:.2f}"
            f" s with loading): {os.path.relpath(path, ROOT)}")

    coords, conn = synthetic_mesh(n_small)
    cfg = hybrid_fea_config(warm_start=False)
    label = f"{3 * n_small} DOF"
    model = timed_build(coords, conn, cfg, device, label)
    rows22 = compare_kernels(model, coords, conn, cfg, device, rng, "22k")
    probe = barrier_probe(device, (k5_grid(model, k5_config(), device),)) \
        if device.type == "cuda" else {}
    rows = []
    t0 = time.perf_counter()
    rows.append(compare_chain_cg(model, conn, k5_config(), device, rng,
                                 probe))
    log(f"K5 comparison phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    err7, *inputs = compare_fixed_order_sums(model, conn, k5_config(),
                                             device, rng, label)
    rows.append(time_ordered_sum(model, *inputs, k5_config(), device, rng,
                                 err7))
    log(f"P7 fixed-order sums phase {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    rows.append(compare_tree_cg(model, conn, cfg, device, rng, "22k", True))
    log(f"K6 comparison phase, 22k, {time.perf_counter() - t0:.2f} s")

    t0 = time.perf_counter()
    coords_b, conn_b = synthetic_mesh(n_big)
    ext = float(coords_b[:, 1].max() - coords_b[:, 1].min())
    grip_b = 0.3 * ext
    # bench.py's 309k configuration
    cfg_b = hybrid_fea_config(warm_start=False, grip_length=grip_b,
                              tree_coarse_weight=0.25)
    label_b = f"{3 * n_big} DOF"
    log(f"{label_b}: synthetic mesh {time.perf_counter() - t0:.2f} s")
    model_b = timed_build(coords_b, conn_b, cfg_b, device, label_b)
    # K1-K3 at the shapes of the 309k plan, where the FEA path launches
    # them: these are the rows' times, the 22k readings ride beside them
    t0 = time.perf_counter()
    rows309 = compare_kernels(model_b, coords_b, conn_b, cfg_b, device, rng,
                              "309k")
    for big, small in zip(rows309, rows22):
        big["max_abs_err"] = max(big["max_abs_err"], small["max_abs_err"])
    rows = rows309 + rows
    log(f"K1-K3 comparison at the 309k shapes {time.perf_counter() - t0:.2f} "
        "s")
    # P7's sums at the FEA path's 309k shapes, where the hybrid factors 2
    # PCR levels: K2 on a level with Schur corrections and fill edges
    t0 = time.perf_counter()
    row7 = next(r for r in rows if r["name"] == "ordered_sum")
    row7["max_abs_err"] = max(row7["max_abs_err"], compare_fixed_order_sums(
        model_b, conn_b, k5_config(grip_length=grip_b), device, rng, label_b,
        big_pcr_levels)[0])
    time_ordered_sum_short(model_b, row7, device)
    log(f"P7 fixed-order sums phase, {label_b}, "
        f"{time.perf_counter() - t0:.2f} s")

    # K6 against its plain version on the deeper forests of the larger
    # meshes the main paths solve, then against the hybrid, in one call, at
    # the three sizes
    routes = {"22k": route_compare(model, coords, conn, cfg, device, label)}
    coords_m, conn_m = synthetic_mesh(n_mid)
    label_m = f"{3 * n_mid} DOF"
    model_m = timed_build(coords_m, conn_m, cfg, device, label_m)
    t0 = time.perf_counter()
    deep = {"99k": compare_tree_cg(model_m, conn_m, cfg, device, rng, "99k",
                                   False)}
    routes["99k"] = route_compare(model_m, coords_m, conn_m, cfg, device,
                                  label_m)
    del model_m
    deep["309k"] = compare_tree_cg(model_b, conn_b, cfg_b, device, rng,
                                   "309k", False)
    log(f"K6 comparison phases, 99k and 309k, with the 99k routes "
        f"{time.perf_counter() - t0:.2f} s")
    # K7 against scipy at 22k and 309k, timed
    t0 = time.perf_counter()
    rows.append(compare_anchored(model, conn, model_b, conn_b, device, rng))
    log(f"K7 comparison phase {time.perf_counter() - t0:.2f} s")
    # K8 against its plain counterpart at 22k and 309k, timed
    t0 = time.perf_counter()
    rows.append(compare_post_solve(model, cfg, model_b, cfg_b, device))
    log(f"K8 comparison phase {time.perf_counter() - t0:.2f} s")
    k6_row = next(r for r in rows if r["name"] == "tree_cg")
    k6_row["max_abs_err"] = max(k6_row["max_abs_err"],
                                *(d["max_abs_err"] for d in deep.values()))
    # K5 at the shapes of the sweep path's 309k solve
    t0 = time.perf_counter()
    k5_row = next(r for r in rows if r["name"] == "chain_cg")
    k5_row["max_abs_err"] = max(k5_row["max_abs_err"], compare_chain_cg_main(
        model_b, conn_b, k5_config(grip_length=grip_b), device))
    log(f"K5 comparison phase, {label_b}, {time.perf_counter() - t0:.2f} s")
    routes["309k"] = route_compare(model_b, coords_b, conn_b, cfg_b, device,
                                   label_b)

    # the FEA path
    reset_launch_counts()
    ms22, it22 = cold_solve(model, coords, conn, cfg, device,
                               f"cold solve {label}", 7,
                               limit=K6_LIMIT if model.tree_kernel
                               else STALL_LIMIT)
    ramp_cfg = hybrid_fea_config()
    n_rec, fractured, ramp_s, loop = ramp_check(coords, conn, ramp_cfg,
                                                model, device)
    async_s = async_check(coords, conn, ramp_cfg, model, device, loop, ramp_s)
    ms309, it309 = cold_solve(model_b, coords_b, conn_b, cfg_b, device,
                                 f"cold solve {label_b}", 5,
                                 limit=K6_LIMIT if model_b.tree_kernel
                                 else STALL_LIMIT)
    # the same system on the hybrid, as a model that cannot run K6 solves
    # it: K1-K3 and the CG loop on the host, with the configuration's
    # coarse weight 0.25 (which K6 does not read)
    hyb309, hyb_it309 = cold_solve(
        dataclasses.replace(model_b, tree_kernel=False), coords_b, conn_b,
        cfg_b, device, f"cold solve {label_b}, hybrid with coarse weight "
        f"{cfg_b.tree_coarse_weight}", 3, limit=STALL_LIMIT)
    sync(device)
    fea_counts = launch_counts()
    log(f"kernel launches on the FEA path: {fea_counts}")
    # K2: one launch a level per factorization of the hybrid's solves
    k2 = model_b.pcr_launch
    log(f"K2 on the FEA path: {fea_counts['pcr_factor']} launches, "
        f"{fea_counts['pcr_factor'] / len(k2.windowed):.2f} factorizations "
        f"of {len(k2.windowed)} PCR levels at {label_b} "
        f"({sum(k2.windowed)} windowed)")
    if device.type == "cuda" and (fea_counts["pcr_factor"] % len(k2.windowed)
                                  or not all(k2.windowed)):
        raise AssertionError("K2: not one launch a windowed level per "
                             "factorization")
    # K3: a hybrid tree apply is 2 launches a PCR level and at most one
    # ordered_sum (read apart from the path's counts)
    hyb_apply = hybrid_apply_check(
        dataclasses.replace(model_b, tree_kernel=False), cfg_b, device)
    # A8: the 22k hybrid's forest apply against the numpy oracle
    oracle22 = forest_oracle_check(model, coords, conn, cfg, device)

    # the sweep path
    t0 = time.perf_counter()
    reset_launch_counts()
    sweep = sweep_path(model, coords, conn, model_b, coords_b, conn_b,
                       grip_b, device)
    sync(device)
    sweep_counts = launch_counts()
    log(f"kernel launches on the sweep path: {sweep_counts} "
        f"({time.perf_counter() - t0:.2f} s)")

    # the growth path at full width
    reset_launch_counts()
    st, gcfg, growth = grow_full_width(big_growth, growth_steps, device)
    grow_counts = launch_counts()
    k4_row = compare_anast(st, gcfg, device, big_growth)
    rows.append(k4_row)
    del st
    trajectory_check(trajectory, GROWTH_PRESETS[trajectory], device)

    # 3D growth, the reference deployment, counts set to 0 around its two
    # runs; K4 on the 150-step state and the two runs again through the
    # plain scan
    import tempfile
    reset_launch_counts()
    st3, cfg3, growth3d = growth_3d_path(device)
    g3_counts = launch_counts()
    k4_row["layouts"] = {"3d": anast_reading(st3, cfg3, device,
                                             "3D, 150 steps", {})}
    del st3
    trajectory_check("3D, 150 steps", cfg3, device)
    # the 9-cell window at full width: the xlarge preset at voxel 0.05
    reset_launch_counts()
    st9, cfg9, growth9 = grow_full_width(big_growth, growth_steps, device,
                                         voxel_size=0.05)
    g9_counts = launch_counts()
    k4_row["layouts"]["9cell"] = anast_reading(
        st9, cfg9, device, f"9-cell window, {big_growth}", {})
    del st9
    trajectory_check("3D, 9-cell window", growth_3d_config(voxel_size=0.05),
                     device)
    # P11: more than 32 tips a cell, both forms
    k4_row["layouts"]["p11"], p11_counts = many_tips_path(device)
    # the 3D pipeline: grow, mesh, read back, the pull test
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        pipe3d = pipeline_3d(device, tmp)
    sync(device)
    p3_counts = launch_counts()
    log(f"kernel launches on the 3D paths: growth {g3_counts}, 9-cell "
        f"{g9_counts}, pipeline {p3_counts}")

    # the coupled pipeline
    reset_launch_counts()
    pipe = coupled_pipeline(coupled, device)
    sync(device)
    pipe_counts = launch_counts()
    log(f"kernel launches on the coupled pipeline: {pipe_counts}")

    # checkpoints: the 22k ramp on its route (K6) and the trajectory
    # preset's growth (K4), each split and resumed
    t0 = time.perf_counter()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = dict(ramp=ramp_checkpoint_check(coords, conn, ramp_cfg, model,
                                               device, loop, tmp),
                    growth=growth_checkpoint_check(trajectory, device, tmp))
    sync(device)
    ckpt_counts = launch_counts()
    log(f"kernel launches on the checkpoint path: {ckpt_counts} "
        f"({time.perf_counter() - t0:.2f} s)")

    # the sharded path over a one-rank group
    t0 = time.perf_counter()
    shard, shard_counts = sharded_path(model, coords, conn, cfg, model_b,
                                       coords_b, conn_b, cfg_b, grip_b,
                                       device)
    log(f"kernel launches on the sharded path: {shard_counts} "
        f"({time.perf_counter() - t0:.2f} s)")
    # growth over the same one-rank group
    shard_growth, shard_growth_counts = sharded_growth_check(device)
    del model_b
    # the scaling path: bench.scaling from 22k to 3M DOF
    scaling, scaling_counts = scaling_path(device, scaling_nodes, rng)
    k6_row["max_abs_err"] = max(k6_row["max_abs_err"],
                                scaling["k6_max_abs_err"])
    # the headline: bench/headline.py at its defaults, before every traced
    # reading (P4)
    head, head_counts = headline_path(device, n_small, n_big)
    # each kernel's launches are read on the path that is its own, and
    # every path must have launched what it is said to run
    hyb = ("chain_matvec", "pcr_factor", "pcr_apply", "ordered_sum")
    own = {"chain_matvec": ("FEA", fea_counts),
           "pcr_factor": ("FEA", fea_counts),
           "ordered_sum": ("FEA", fea_counts),
           "pcr_apply": ("FEA", fea_counts),
           "tree_cg": ("FEA", fea_counts),
           "anchored": ("FEA", fea_counts),
           "post_solve": ("FEA", fea_counts),
           "chain_cg": ("sweep", sweep_counts),
           "anast_scan": ("growth", grow_counts)}
    paths = {"FEA": fea_counts, "sweep": sweep_counts,
             "growth": grow_counts, "growth_3d": g3_counts,
             "growth_9cell": g9_counts, "pipeline_3d": p3_counts,
             "coupled": pipe_counts, "checkpoint": ckpt_counts,
             "sharded": shard_counts, "p11": p11_counts,
             "sharded_growth": shard_growth_counts,
             "scaling": scaling_counts, "headline": head_counts}
    for row in rows:
        row["path"], counts = own[row["name"]]
        row["launches"] = counts[row["name"]]
        row["launches_by_path"] = {p: c[row["name"]]
                                   for p, c in paths.items()}
    if device.type == "cuda":
        solve = ("tree_cg",) if model.tree_kernel else hyb
        pipe_solve = ("tree_cg",) if pipe["route"] == "tree_cg" else hyb
        missing = [f"{r['path']} {r['name']}" for r in rows
                   if r["launches"] < 1]
        missing += [f"sweep {k}" for k in hyb + solve if sweep_counts[k] < 1]
        # every pull test's post-solve on the card is K8
        missing += [f"coupled {k}" for k in pipe_solve + ("anast_scan",
                                                          "post_solve")
                    if pipe_counts[k] < 1]
        missing += [f"checkpoint {k}" for k in ("tree_cg", "anast_scan",
                                                "post_solve")
                    if ckpt_counts[k] < 1]
        missing += [f"{p} anast_scan" for p, c in (
            ("growth_3d", g3_counts), ("growth_9cell", g9_counts),
            ("pipeline_3d", p3_counts), ("p11", p11_counts),
            ("sharded_growth", shard_growth_counts))
            if c["anast_scan"] < 1]
        missing += [f"pipeline_3d {k}" for k in ("tree_cg", "post_solve")
                    if p3_counts[k] < 1]
        missing += [f"headline {k}" for k in ("tree_cg", "post_solve")
                    if head_counts[k] < 1]
        missing += [f"sharded {k}" for k in ("pcr_factor", "pcr_apply",
                                             "ordered_sum", "post_solve")
                    if shard_counts[k] < 1]
        if missing:
            raise AssertionError(f"kernels never launched: {missing}")
    # every traced reading, now that nothing timed on the host follows
    t0 = time.perf_counter()
    run_deferred(device)
    log(f"device times and the K6 solve's footprint "
        f"{time.perf_counter() - t0:.2f} s")
    import torch.distributed as dist
    dist.destroy_process_group()
    # the 22k readings of K1-K3 beside the rows' own (the 309k shapes)
    for big, small in zip(rows309, rows22):
        big.update({f"{k}_22k": v for k, v in small.items()
                    if k.endswith("ms")})
    log(f"smoke wall time {time.perf_counter() - t_start:.1f} s")
    return dict(kernels=rows, routes=routes, barrier_us_by_blocks=probe,
                solve_ms_22k=ms22,
                iters_22k=it22, ramp_s_22k=ramp_s, ramp_async_s_22k=async_s,
                ramp_steps_22k=n_rec,
                ramp_fractured_22k=fractured, solve_ms_309k=ms309,
                iters_309k=it309, hybrid_ms_309k=hyb309,
                hybrid_iters_309k=hyb_it309, hybrid_apply_309k=hyb_apply,
                forest_oracle_22k=oracle22, scaling=scaling, headline=head,
                sweep=sweep, growth=growth, growth_3d=growth3d,
                growth_9cell=growth9, pipeline_3d=pipe3d,
                coupled=pipe, checkpoints=ckpt, sharded=shard,
                sharded_growth=shard_growth)


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
    print(json.dumps(out["headline"]["row"]))
    print(card)
    print(json.dumps({"kernels": out["kernels"]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
