"""The quasi-static tensile pull test (port of ``mycelium_tpu/fea/ramp.py``:
``RampResult``, ``ramp_step``, ``post_solve``, ``anchored_mask_host``,
``anchored_mask_device``, the ``run_ramp`` loop with its checkpoints,
``run_ramp_sharded`` and the device-resident loops ``run_ramp_async`` and
``run_ramp_scan``).

40-step displacement ramp, dy = ±displacement_max·step/(n_steps−1): solve
under grip BCs, reactions with the pre-BC stiffness, axial strains on the
undeformed geometry, deactivate elements with |strain| > max_strain,
record force–displacement, stop early once the network has fully
fractured. The tree-PC factorization (and the coarse inverse it carries
with tree_coarse_weight > 0) is reused across steps whose active mask did
not change; a fracture event refreshes the grip reachability (on the
device: ``tree_anchored`` where the model has a forest, else
``anchored_mask_device``) and the factorization. Solves that go to the
whole-solve tree kernel (``solve_route`` 'tree_cg') set up and factor inside
their launch, so no factorization is kept for them; a solution returned
there is a buffer of the model's launch that the solve after next
overwrites, which is why the loops keep only the previous step's solution
(for the warm start) and copy what they record.

``run_ramp`` reads the step's records on the host every step.
``run_ramp_async`` and ``run_ramp_scan`` keep them in preallocated device
tensors written by step index and fetch them once at the end; what they
still read on the host each step is the solve's three stats (one read, in
``solve_displacement``) and one ``changed`` flag, plus one flag a trip of
the reachability fixpoint after a fracture.

Under a profiler the loops hold the spans of ``utils.profiling``: a pull
test (``fea.ramp``), the refresh and each of its trips, ``post_solve``,
each host read (``fea.sync.*``) and the records' writes and fetches
(``fea.records.*``); ``solve_displacement`` holds its own.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..devices import DEFAULT_DEVICE
from ..utils.profiling import span
from .elements import element_strain
from .model import FeaModel, apply_stiffness, build_model
from .solve import compute_tree_factor, solve_displacement, solve_route


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


def anchored_mask_device(model: FeaModel, active):
    """Grip reachability on the device by monotone label propagation over
    the ELL neighbour table: O(graph diameter) sweeps, each one gather and
    one host read of the ``changed`` flag."""
    grip = model.top_nodes | model.bot_nodes
    false1 = torch.zeros((1,), dtype=torch.bool, device=grip.device)
    link_ok = torch.cat([active.to(torch.bool), false1])[model.incident]
    anch = grip
    while True:
        with span("fea.refresh.trip"):
            nb = torch.cat([anch, false1])[model.neighbor] & link_ok
            new = grip | nb.any(dim=1)
            with span("fea.sync.trip"):
                changed = bool((new != anch).any())
        if not changed:
            return new
        anch = new


def refresh_anchored(model: FeaModel, active):
    """The grip reachability of ``active`` on the model's device: the
    tree-accelerated sweep where the model has a forest."""
    with span("fea.refresh"):
        if model.tree_fast is not None:
            from .tree_factor import tree_anchored
            return tree_anchored(model.tree, model, active)
        return anchored_mask_device(model, active)


def keeps_factor(model: FeaModel, cfg) -> bool:
    """Whether the ramp keeps a tree-PC factorization between steps: the
    tree preconditioner on every route but the whole-solve kernel, which
    factors inside its launch."""
    return cfg.precond == "tree" and solve_route(model, cfg) != "tree_cg"


def post_solve(model: FeaModel, cfg, u, active):
    """Reactions -> stress -> fracture for a solved displacement field."""
    with span("fea.post_solve"):
        f_react = apply_stiffness(model, u, active,
                                  "scatter" if cfg.operator == "scatter"
                                  else "ell")
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


class _Records:
    """The per-step records of the loop drivers, with their checkpoint
    files: ``resume`` reads a file's position, mask, last displacement and
    records, ``save`` writes them (coordinator only). The file's names are
    the JAX package's, so a file written by either package resumes in the
    other."""

    def __init__(self):
        self.stress, self.active, self.disp, self.fd = [], [], [], []
        self.secs, self.iters = [], []

    def resume(self, path: str, cfg):
        """(next step, active mask, last displacement, previous step's
        ramp factor) of the file at ``path``; its records become these."""
        from ..io.checkpoint import load_ramp_state
        step, active_np, u_prev, recs = load_ramp_state(path)
        self.stress = list(recs["stress"])
        self.active = list(recs["active"])
        self.disp = list(recs["disp"])
        self.fd = [list(r) for r in recs["fd"]]
        self.secs = list(recs["solve_secs"])
        self.iters = [int(i) for i in recs["iters"]]
        prev_factor = (step - 1) / (cfg.n_steps - 1) if step > 0 else 0.0
        return step, active_np.astype(bool), u_prev, prev_factor

    def add(self, stress, active_np, u, dy: float, force: float,
            secs: float, iters: int) -> None:
        self.stress.append(stress.cpu().numpy())
        self.active.append(active_np)
        self.disp.append(u.cpu().numpy().reshape(-1))
        self.fd.append([dy, force])
        self.secs.append(secs)
        self.iters.append(int(iters))

    def save(self, path: str, next_step: int, active_np, u_prev) -> None:
        """``u_prev`` is copied to the host: a K6 result is a launch
        buffer, and a resumed run takes its warm start from the file."""
        from ..io.checkpoint import save_ramp_state
        save_ramp_state(path, next_step, active_np, u_prev.cpu().numpy(),
                        records=dict(
                            stress=np.stack(self.stress),
                            active=np.stack(self.active),
                            disp=np.stack(self.disp),
                            fd=np.asarray(self.fd, dtype=np.float64),
                            solve_secs=np.asarray(self.secs),
                            iters=np.asarray(self.iters, dtype=np.int64)))

    def result(self, t0: float) -> RampResult:
        return RampResult(
            stress_record=np.stack(self.stress),
            active_record=np.stack(self.active),
            disp_record=np.stack(self.disp),
            force_disp=np.asarray(self.fd, dtype=np.float64),
            solve_seconds=np.asarray(self.secs),
            cg_iters=np.asarray(self.iters, dtype=np.int64),
            total_seconds=time.perf_counter() - t0)


def _ramp_start(model: FeaModel, cfg, recs: _Records,
                resume_from: Optional[str]):
    """(first step, active mask on the host and on the device, last
    displacement, previous ramp factor): the ramp's start, or the
    position of the checkpoint ``resume_from``."""
    dtype, dev = model.dtype, model.device
    if resume_from is None:
        active_np = np.ones(model.n_elems, bool)
        u_prev = torch.zeros((model.n_nodes, 3), dtype=dtype, device=dev)
        return 0, active_np, torch.as_tensor(active_np, device=dev), \
            u_prev, 0.0
    step, active_np, u_np, prev_factor = recs.resume(resume_from, cfg)
    return step, active_np, torch.as_tensor(active_np, device=dev), \
        torch.as_tensor(u_np, dtype=dtype, device=dev), prev_factor


def _checkpoint_due(path, every: int, step: int, start_step: int) -> bool:
    return path is not None and every > 0 \
        and (step + 1 - start_step) % every == 0


def _loop_ramp(model: FeaModel, cfg, step_fn, use_fac: bool,
               checkpoint_path: Optional[str], checkpoint_every: int,
               resume_from: Optional[str]) -> _Records:
    """The loop of ``run_ramp`` and ``run_ramp_sharded``: ``step_fn(active,
    x0, dy_top, dy_bot, anchored, factor)`` is the step (what
    ``ramp_step`` returns), and the tree-PC factorization is kept between
    steps where ``use_fac``."""
    recs = _Records()
    start_step, active_np, active, u_prev, prev_factor = _ramp_start(
        model, cfg, recs, resume_from)

    anchored = refresh_anchored(model, active)
    fac = compute_tree_factor(model, active, cfg, anchored) if use_fac \
        else None

    for step in range(start_step, cfg.n_steps):
        if step > 0 and not active_np.any():
            break   # resumed past full fracture: nothing left to solve
        dy_top, dy_bot = _step_factors(cfg, step)
        # warm start: the response is linear between fracture events
        factor = step / (cfg.n_steps - 1)
        if cfg.warm_start and prev_factor > 0:
            x0 = u_prev * (factor / prev_factor)
        else:
            x0 = torch.zeros_like(u_prev)
        ts = time.perf_counter()
        u, stress, active_new, total_force, iters, resnorm, converged = \
            step_fn(active, x0, dy_top, dy_bot, anchored, fac)
        _check_converged(converged, step, resnorm)
        secs = time.perf_counter() - ts

        with span("fea.records.fetch"):
            active_new_np = active_new.cpu().numpy()
            recs.add(stress, active_new_np, u, dy_top - dy_bot,
                     float(total_force), secs, iters)

        if not np.array_equal(active_new_np, active_np):
            # fracture changed the topology: refresh grip reachability and
            # the tree-PC factorization
            anchored = refresh_anchored(model, active_new)
            if use_fac:
                fac = compute_tree_factor(model, active_new, cfg, anchored)
        u_prev, active, active_np, prev_factor = \
            u, active_new, active_new_np, factor
        if _checkpoint_due(checkpoint_path, checkpoint_every, step,
                           start_step):
            recs.save(checkpoint_path, step + 1, active_np, u_prev)
        if not active_new_np.any():
            break   # early stop on full fracture
    return recs


def run_ramp(coords, conn, cfg, device=DEFAULT_DEVICE,
             model: Optional[FeaModel] = None,
             checkpoint_path: Optional[str] = None,
             checkpoint_every: int = 0,
             resume_from: Optional[str] = None) -> RampResult:
    """Python-loop pull-test ramp with warm starts, factor reuse and the
    reference's early stop on full fracture, on ``model`` if given, else
    on a model built on ``device`` (the card unless the caller passes
    "cpu").

    With ``checkpoint_path`` and ``checkpoint_every`` > 0 the ramp's state
    (next step, active mask, last displacement, records) is saved after
    every step with (step + 1 - first step) % checkpoint_every == 0;
    ``resume_from`` goes on from such a file: the grip reachability and
    the factorization are rebuilt from its mask and the warm start comes
    from its displacement, so the records equal the unsplit run's."""
    t0 = time.perf_counter()
    if model is None:
        model = build_model(coords, conn, cfg, device)

    def step_fn(active, x0, dy_top, dy_bot, anchored, fac):
        return ramp_step(model, cfg, active, x0, dy_top, dy_bot, anchored,
                         fac)

    with span("fea.ramp"):
        return _loop_ramp(model, cfg, step_fn, keeps_factor(model, cfg),
                          checkpoint_path, checkpoint_every,
                          resume_from).result(t0)


def run_ramp_sharded(coords, conn, cfg, device=DEFAULT_DEVICE,
                     model: Optional[FeaModel] = None, group=None,
                     checkpoint_path: Optional[str] = None,
                     checkpoint_every: int = 0,
                     resume_from: Optional[str] = None) -> RampResult:
    """The pull test with every solve domain-decomposed over the ranks of
    ``group`` (``fea/shard.py``; the default process group if None).
    Every rank runs this driver with the same arguments, on its own device
    (``utils.dist.rank_device``): the tree-PC factorization is computed on
    every rank and reused while the mask is unchanged, the grip
    reachability is refreshed after each fracture, and the reactions,
    stresses and fractures are computed on the full solution on every
    rank. The checkpoint arguments are ``run_ramp``'s; only the
    coordinator writes."""
    from .shard import sharded_cg_solver
    t0 = time.perf_counter()
    if model is None:
        model = build_model(coords, conn, cfg, device)
    solver = sharded_cg_solver(model, cfg, group)

    def step_fn(active, x0, dy_top, dy_bot, anchored, fac):
        res = solver(active, dy_top, dy_bot, x0, anchored, fac)
        stress, active_new, total_force = post_solve(model, cfg, res.x,
                                                     active)
        return (res.x, stress, active_new, total_force, res.iters,
                res.resnorm, res.converged)

    use_fac = cfg.precond == "tree" and model.tree_fast is not None
    with span("fea.ramp"):
        return _loop_ramp(model, cfg, step_fn, use_fac, checkpoint_path,
                          checkpoint_every, resume_from).result(t0)


def truncate_after_fracture(res: RampResult) -> RampResult:
    """Cut records at the early-stop point ``run_ramp`` would have
    produced: up to and including the step where the last element
    fractured."""
    n_active = res.active_record.sum(axis=1)
    dead = np.nonzero(n_active == 0)[0]
    n_rec = (dead[0] + 1) if len(dead) else len(n_active)
    return RampResult(*(x[:n_rec] for x in res[:6]), res.total_seconds)


def _check_status(status: np.ndarray, n_done: int) -> None:
    """Raise if a step whose network was still alive did not converge.
    status rows: [converged, active elements after, iterations, force]."""
    conv = status[:n_done, 0] > 0
    alive_before = np.concatenate([[1.0], status[:n_done - 1, 1]]) > 0
    bad = np.nonzero(~conv & alive_before)[0]
    if len(bad):
        raise SolveDivergedError(
            f"solver diverged at ramp step {int(bad[0]) + 1}")


def _device_ramp(model: FeaModel, cfg, sync_every: int, early_stop: bool):
    """The ramp with device-resident records: (stress, active, disp,
    status) tensors of n_steps rows written by step index, the per-step
    seconds (wall time between status reads spread over the steps between
    them) and the number of steps run. The status rows are read on the
    host every ``sync_every`` steps (0: only at the end), where the early
    stop and the divergence check run."""
    dtype, dev = model.dtype, model.device
    n_steps = cfg.n_steps
    use_fac = keeps_factor(model, cfg)
    active = torch.ones(model.n_elems, dtype=torch.bool, device=dev)
    u_prev = torch.zeros((model.n_nodes, 3), dtype=dtype, device=dev)
    anchored = refresh_anchored(model, active)
    fac = compute_tree_factor(model, active, cfg, anchored) if use_fac \
        else None
    stress_b = torch.zeros((n_steps, model.n_elems), dtype=dtype, device=dev)
    active_b = torch.zeros((n_steps, model.n_elems), dtype=torch.bool,
                           device=dev)
    disp_b = torch.zeros((n_steps, 3 * model.n_nodes), dtype=dtype,
                         device=dev)
    # float64 rows: the force keeps every bit it has on the device, and the
    # counts are exact
    status_b = torch.zeros((n_steps, 4), dtype=torch.float64, device=dev)

    secs = np.zeros((n_steps,))
    chunk_lo, chunk_t0 = 0, time.perf_counter()

    def close_chunk(hi):
        nonlocal chunk_lo, chunk_t0
        now = time.perf_counter()
        if hi > chunk_lo:
            secs[chunk_lo:hi] = (now - chunk_t0) / (hi - chunk_lo)
        chunk_lo, chunk_t0 = hi, now

    prev_factor = 0.0
    done = 0
    for step in range(n_steps):
        dy_top, dy_bot = _step_factors(cfg, step)
        factor = step / (n_steps - 1)
        if cfg.warm_start and prev_factor > 0:
            x0 = u_prev * (factor / prev_factor)
        else:
            x0 = torch.zeros_like(u_prev)
        u, stress, active_new, total_force, iters, _, converged = ramp_step(
            model, cfg, active, x0, dy_top, dy_bot, anchored, fac)
        with span("fea.records.write"):
            stress_b[step] = stress
            active_b[step] = active_new
            disp_b[step] = u.reshape(-1)
            status_b[step, 0] = float(converged)
            status_b[step, 1] = active_new.sum()
            status_b[step, 2] = float(iters)
            status_b[step, 3] = total_force
        # the refresh is data-dependent: one flag a step
        with span("fea.sync.flag"):
            changed = bool((active_new != active).any())
        if changed:
            anchored = refresh_anchored(model, active_new)
            if use_fac:
                fac = compute_tree_factor(model, active_new, cfg, anchored)
        u_prev, active, prev_factor = u, active_new, factor
        done = step + 1
        if sync_every > 0 and done % sync_every == 0 and done < n_steps:
            with span("fea.sync.status"):
                status = status_b.cpu().numpy()
            close_chunk(done)
            _check_status(status, done)
            if early_stop and status[done - 1, 1] == 0:
                break
    with span("fea.sync.status"):
        status = status_b.cpu().numpy()
    close_chunk(done)
    _check_status(status, done)
    return stress_b, active_b, disp_b, status, secs, done


def _device_result(model, cfg, bufs, t0) -> RampResult:
    stress_b, active_b, disp_b, status, secs, done = bufs
    factors = np.arange(done) / (cfg.n_steps - 1)
    fd = np.stack([2 * cfg.displacement_max * factors, status[:done, 3]],
                  axis=1)
    with span("fea.records.fetch"):
        stress, active, disp = (b[:done].cpu().numpy()
                                for b in (stress_b, active_b, disp_b))
    return RampResult(
        stress_record=stress, active_record=active, disp_record=disp,
        force_disp=fd,
        solve_seconds=secs[:done],
        cg_iters=status[:done, 2].astype(np.int64),
        total_seconds=time.perf_counter() - t0)


def _device_run(model, cfg, sync_every: int, early_stop: bool,
                t0: float) -> RampResult:
    """One pull test of the device-resident loop, its records fetched."""
    with span("fea.ramp"):
        return _device_result(model, cfg, _device_ramp(
            model, cfg, sync_every, early_stop), t0)


def run_ramp_async(coords, conn, cfg, device=DEFAULT_DEVICE,
                   model: Optional[FeaModel] = None,
                   sync_every: int = 8) -> RampResult:
    """The ramp with device-resident records: the per-step record pulls
    of ``run_ramp`` are replaced by one status read every ``sync_every``
    steps and one record fetch at the end. The early stop and the
    divergence check run at that granularity, and the records are cut at
    the full-fracture step as ``run_ramp`` cuts them. ``solve_seconds`` is
    chunk-amortised: each sync chunk's wall time spread evenly over its
    steps."""
    t0 = time.perf_counter()
    if model is None:
        model = build_model(coords, conn, cfg, device)
    return truncate_after_fracture(_device_run(
        model, cfg, max(int(sync_every), 1), True, t0))


def run_ramp_scan(coords, conn, cfg, device=DEFAULT_DEVICE,
                  model: Optional[FeaModel] = None) -> RampResult:
    """The ramp with no early stop and no status read before the end:
    every step runs (after full fracture the remaining solves are trivial
    identity solves) and ``solve_seconds`` is NaN, as in the reference.
    Cut the records with ``truncate_after_fracture``. Every model and
    route runs the same loop: the reference sends its large models to
    ``run_ramp`` because one compiled program for all steps is costly
    there, and no such program exists here."""
    t0 = time.perf_counter()
    if model is None:
        model = build_model(coords, conn, cfg, device)
    res = _device_run(model, cfg, 0, False, t0)
    return res._replace(solve_seconds=np.full((cfg.n_steps,), np.nan))
