"""The quasi-static tensile pull test (port of ``mycelium_tpu/fea/ramp.py``:
``RampResult``, ``ramp_step``, ``post_solve``, ``anchored_mask_host``, the
``run_ramp`` loop with its checkpoints, ``run_ramp_sharded`` and the
device-resident loops ``run_ramp_async`` and ``run_ramp_scan``).

40-step displacement ramp, dy = ±displacement_max·step/(n_steps−1): solve
under grip BCs, reactions with the pre-BC stiffness, axial strains on the
undeformed geometry, deactivate elements with |strain| > max_strain,
record force–displacement, stop early once the network has fully
fractured. The tree-PC factorization (and the coarse inverse it carries
with tree_coarse_weight > 0) is reused across steps whose active mask did
not change; a fracture event refreshes the grip reachability (on the
card K7, ``kernels.AnchoredLaunch``, one launch; on the CPU the fixpoint
``tree_anchored``) and the factorization. Solves that go to the
whole-solve tree kernel (``solve_route`` 'tree_cg') set up and factor inside
their launch, so no factorization is kept for them; a solution returned
there is a buffer of the model's launch that the solve after next
overwrites, which is why the loop keeps only the previous step's solution
(for the warm start) and copies what it records.

The four ramp functions run one step loop (``_loop``) and differ in their
record keeper. ``_Records`` (``run_ramp``, ``run_ramp_sharded``) reads the
step's records on the host every step. ``_DeviceRecords`` (``run_ramp_async``,
``run_ramp_scan``) keeps them in preallocated device tensors written by
step index and fetches them once at the end: on the card into page-locked
host tensors of their own, by three asynchronous copies and one wait, so
the result's arrays are complete when it is returned and no later test
writes over them.

On the card a step's post-solve is one launch of K8
(``kernels.PostSolveLaunch``, every driver): stress, fracture, the top
grip's reaction and the counts, written straight into the step's record
rows (``_DeviceRecords``' own rows; fresh ones for ``_Records``, which reads
them on the host and keeps its divergence refusal and mask compare there),
with the status row and a ``changed`` flag. So between the solve's stats
read and the step's flag read the host issues that one launch. On the CPU
``post_solve`` is the plain arithmetic and writes the same rows and flag
itself. What ``_DeviceRecords`` reads on the host each step is the solve's
three stats (one read, in ``solve_displacement``) and the flag; on the CPU
also one flag a trip of the reachability fixpoint after a fracture (on the
card the refresh is one launch and reads nothing back).

Under a profiler the loop holds the spans of ``utils.profiling``: a pull
test (``fea.ramp``), the refresh and each of its trips, ``post_solve`` (on
the card each K8 launch also counts one ``fea.post.kernel``), each host
read (``fea.sync.*``) and the records' writes (the CPU's, inside
``post_solve``) and fetches (``fea.records.*``); ``solve_displacement`` holds its own. The card's
fetch counts its bytes (``fea.records.pinned_bytes``) and whether it had to
page-lock new host memory (``fea.records.pinned_fresh``).
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..devices import DEFAULT_DEVICE
from ..kernels.post_solve import (ACTIVE, CONVERGED, FORCE, ITERS, PostRows,
                                  status_row)
from ..utils import profiling
from ..utils.profiling import count, span
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


def refresh_anchored(model: FeaModel, active):
    """The grip reachability of ``active`` on its device, whatever the
    model: for CUDA tensors K7, one launch of union-find over the active
    elements and no host read (``model.anchored_launch``); for CPU tensors
    the fixpoint ``tree_anchored``, which on a forest with no levels (no
    free node) is the plain neighbour sweep. The card's one launch is the
    refresh's one trip."""
    with span("fea.refresh"):
        if active.device.type == "cuda":
            with span("fea.refresh.trip"):
                return model.anchored_launch.mask(active)
        from .tree_factor import tree_anchored
        return tree_anchored(model.tree, model, active)


def keeps_factor(model: FeaModel, cfg) -> bool:
    """Whether the ramp keeps a tree-PC factorization between steps: the
    tree preconditioner on every route but the whole-solve kernel, which
    factors inside its launch."""
    return cfg.precond == "tree" and solve_route(model, cfg) != "tree_cg"


def post_solve(model: FeaModel, cfg, u, active, rows=None, converged=True,
               iters=0):
    """Reactions -> stress -> fracture for a solved displacement field:
    (stress, active_new, total_force), and the step's record rows
    (``kernels.PostRows``) where ``rows`` is given: stress, mask, a copy of
    ``u``, the status row (``kernels.post_solve.status_row``, with the
    solve's ``converged`` and ``iters``) and the ``changed`` flag.

    On CUDA tensors one launch of K8 (``model.post_launch``) writes the rows
    (fresh ones where none are given), the force summed in float64 over the
    top grip's element ends; it returns their stress, mask and force (a
    float64 view). Under a profiler each launch counts one
    ``fea.post.kernel``. On CPU tensors the plain arithmetic: the top grip's
    y-reactions of the whole operator, strain, stress, fracture, then the
    rows' writes (span ``fea.records.write``)."""
    with span("fea.post_solve"):
        if u.device.type == "cuda":
            launch = model.post_launch
            rows = launch.launch(u, active,
                                 launch.rows() if rows is None else rows,
                                 cfg.e_mod, cfg.max_strain, converged, iters)
            count("fea.post.kernel")
            return rows.stress, rows.active, rows.status[FORCE]
        f_react = apply_stiffness(model, u, active,
                                  "scatter" if cfg.operator == "scatter"
                                  else "ell")
        total_force = torch.where(model.top_nodes, f_react[:, 1], 0.0).sum()
        strain = element_strain(u, model.conn, model.geom)
        stress = torch.where(active, cfg.e_mod * strain, 0.0)
        active_new = active & (strain.abs() <= cfg.max_strain)
        if rows is not None:
            with span("fea.records.write"):
                rows.stress.copy_(stress)
                rows.active.copy_(active_new)
                rows.disp.copy_(u.reshape(-1))
                rows.status.copy_(status_row(converged, active_new.sum(),
                                             iters, total_force))
                rows.changed.copy_((active_new != active).any())
        return stress, active_new, total_force


def ramp_step(model: FeaModel, cfg, active, x0, dy_top: float,
              dy_bot: float, anchored=None, tree_factor_val=None, rows=None):
    """One ramp step: solve -> reactions -> stress -> fracture; the
    post-solve writes ``rows`` where given (``post_solve``)."""
    res = solve_displacement(model, active, dy_top, dy_bot, x0, cfg,
                             anchored, tree_factor_val=tree_factor_val)
    stress, active_new, total_force = post_solve(
        model, cfg, res.x, active, rows, res.converged, res.iters)
    return (res.x, stress, active_new, total_force, res.iters, res.resnorm,
            res.converged)


class _Records:
    """The records of ``run_ramp`` and ``run_ramp_sharded``, read on the
    host every step, with their checkpoint files: the ramp goes on from
    the file ``resume_from``, and its state (next step, active mask, last
    displacement, records) is saved to ``checkpoint_path`` after every
    step with (step + 1 - first step) % ``checkpoint_every`` == 0
    (coordinator only). The file's names are the JAX package's, so a file
    written by either package resumes in the other."""

    def __init__(self, checkpoint_path: Optional[str],
                 checkpoint_every: int, resume_from: Optional[str]):
        self.path, self.every = checkpoint_path, checkpoint_every
        self.resume_from = resume_from
        self.stress, self.active, self.disp, self.fd = [], [], [], []
        self.secs, self.iters = [], []

    def start(self, model: FeaModel, cfg):
        """The ramp's start, or the position of the file ``resume_from``,
        whose records become these; a file past full fracture leaves no
        step to run."""
        self.cfg = cfg
        if self.resume_from is None:
            self.first, self.mask = 0, np.ones(model.n_elems, bool)
            return _fresh_start(model)
        from ..io.checkpoint import load_ramp_state
        step, active_np, u_np, recs = load_ramp_state(self.resume_from)
        self.stress = list(recs["stress"])
        self.active = list(recs["active"])
        self.disp = list(recs["disp"])
        self.fd = [list(r) for r in recs["fd"]]
        self.secs = list(recs["solve_secs"])
        self.iters = [int(i) for i in recs["iters"]]
        self.first, self.mask = step, active_np.astype(bool)
        prev_factor = (step - 1) / (cfg.n_steps - 1) if step > 0 else 0.0
        dev = model.device
        return (step if self.mask.any() else cfg.n_steps,
                torch.as_tensor(self.mask, device=dev),
                torch.as_tensor(u_np, dtype=model.dtype, device=dev),
                prev_factor)

    def rows(self, step: int):
        """None: the step's post-solve writes fresh rows, read here."""
        return None

    def record(self, step: int, ts: float, active, out) -> bool:
        """Refuse a solve that did not converge, read the step's records
        and compare its mask with the last on the host."""
        u, stress, active_new, total_force, iters, resnorm, converged = out
        if not converged:
            raise SolveDivergedError(
                f"solver diverged at ramp step {step + 1}: |r| = "
                f"{resnorm:.3e} after max_iter iterations")
        secs = time.perf_counter() - ts
        dy_top, dy_bot = _step_factors(self.cfg, step)
        with span("fea.records.fetch"):
            mask = active_new.cpu().numpy()
            self.stress.append(stress.cpu().numpy())
            self.active.append(mask)
            self.disp.append(u.cpu().numpy().reshape(-1))
            self.fd.append([dy_top - dy_bot, float(total_force)])
            self.secs.append(secs)
            self.iters.append(int(iters))
        changed = not np.array_equal(mask, self.mask)
        self.mask = mask
        return changed

    def after(self, step: int, u_prev) -> bool:
        """Save the state where a checkpoint is due; stop on full
        fracture."""
        if self.path is not None and self.every > 0 \
                and (step + 1 - self.first) % self.every == 0:
            self.save(step + 1, u_prev)
        return not self.mask.any()

    def save(self, next_step: int, u_prev) -> None:
        """``u_prev`` is copied to the host: a K6 result is a launch
        buffer, and a resumed run takes its warm start from the file."""
        from ..io.checkpoint import save_ramp_state
        save_ramp_state(self.path, next_step, self.mask,
                        u_prev.cpu().numpy(),
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


def _fresh_start(model: FeaModel):
    """(first step, active mask, last displacement, previous ramp factor)
    of a ramp from its start."""
    dev = model.device
    return (0, torch.ones(model.n_elems, dtype=torch.bool, device=dev),
            torch.zeros((model.n_nodes, 3), dtype=model.dtype, device=dev),
            0.0)


def _loop(model: FeaModel, cfg, step_fn, keeps: bool, recs):
    """The pull test's step loop, for every ramp function.
    ``step_fn(active, x0, dy_top, dy_bot, anchored, factor, rows)`` is the
    step (what ``ramp_step`` returns), and the tree-PC factorization is
    kept between steps where ``keeps``. ``recs`` keeps the records:
    ``start`` gives the first step and its state, ``rows`` the step's record
    rows for the post-solve to write (or None), ``record`` takes the step's
    results and says whether the mask changed, and ``after``, called once
    the refresh is enqueued, says whether to stop. Returns ``recs``."""
    first, active, u_prev, prev_factor = recs.start(model, cfg)
    anchored = refresh_anchored(model, active)
    fac = compute_tree_factor(model, active, cfg, anchored) if keeps \
        else None
    for step in range(first, cfg.n_steps):
        dy_top, dy_bot = _step_factors(cfg, step)
        # warm start: the response is linear between fracture events
        factor = step / (cfg.n_steps - 1)
        if cfg.warm_start and prev_factor > 0:
            x0 = u_prev * (factor / prev_factor)
        else:
            x0 = torch.zeros_like(u_prev)
        ts = time.perf_counter()
        out = step_fn(active, x0, dy_top, dy_bot, anchored, fac,
                      recs.rows(step))
        u, active_new = out[0], out[2]
        if recs.record(step, ts, active, out):
            # fracture changed the topology: refresh grip reachability and
            # the tree-PC factorization
            anchored = refresh_anchored(model, active_new)
            if keeps:
                fac = compute_tree_factor(model, active_new, cfg, anchored)
        u_prev, active, prev_factor = u, active_new, factor
        if recs.after(step, u_prev):
            break
    return recs


def _ramp_steps(model: FeaModel, cfg):
    """The step of ``run_ramp``, ``run_ramp_async`` and ``run_ramp_scan``
    (``ramp_step``, looked up at every call) and its factor rule."""
    def step_fn(active, x0, dy_top, dy_bot, anchored, fac, rows):
        return ramp_step(model, cfg, active, x0, dy_top, dy_bot, anchored,
                         fac, rows)
    return step_fn, keeps_factor(model, cfg)


def _pull_test(coords, conn, cfg, device, model: Optional[FeaModel], recs,
               steps) -> RampResult:
    """One pull test of a ramp function: on ``model`` if given, else on a
    model built on ``device``, with the step and factor rule that
    ``steps(model, cfg)`` gives and the record keeper ``recs``."""
    t0 = time.perf_counter()
    if model is None:
        model = build_model(coords, conn, cfg, device)
    step_fn, keeps = steps(model, cfg)
    with span("fea.ramp"):
        return _loop(model, cfg, step_fn, keeps, recs).result(t0)


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
    return _pull_test(coords, conn, cfg, device, model, _Records(
        checkpoint_path, checkpoint_every, resume_from), _ramp_steps)


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

    def sharded_steps(model, cfg):
        solver = sharded_cg_solver(model, cfg, group)

        def step_fn(active, x0, dy_top, dy_bot, anchored, fac, rows):
            res = solver(active, dy_top, dy_bot, x0, anchored, fac)
            stress, active_new, total_force = post_solve(
                model, cfg, res.x, active, rows, res.converged, res.iters)
            return (res.x, stress, active_new, total_force, res.iters,
                    res.resnorm, res.converged)
        # the sharded solver has no whole-solve route
        return step_fn, cfg.precond == "tree"

    return _pull_test(coords, conn, cfg, device, model, _Records(
        checkpoint_path, checkpoint_every, resume_from), sharded_steps)


def truncate_after_fracture(res: RampResult) -> RampResult:
    """Cut records at the early-stop point ``run_ramp`` would have
    produced: up to and including the step where the last element
    fractured."""
    n_active = res.active_record.sum(axis=1)
    dead = np.nonzero(n_active == 0)[0]
    n_rec = (dead[0] + 1) if len(dead) else len(n_active)
    return RampResult(*(x[:n_rec] for x in res[:6]), res.total_seconds)


def _check_status(status: np.ndarray, n_done: int) -> None:
    """Raise if a step whose network was still alive did not converge
    (``status``: the steps' status rows)."""
    conv = status[:n_done, CONVERGED] > 0
    alive_before = np.concatenate([[1.0], status[:n_done - 1, ACTIVE]]) > 0
    bad = np.nonzero(~conv & alive_before)[0]
    if len(bad):
        raise SolveDivergedError(
            f"solver diverged at ramp step {int(bad[0]) + 1}")


class _DeviceRecords:
    """The records of ``run_ramp_async`` and ``run_ramp_scan``: (stress,
    active, disp, status) tensors of n_steps rows on the model's device,
    written by step index, and the per-step seconds (the wall time of a
    chunk of steps, from its first step to the status read that closes
    it, spread over its steps). The step's post-solve writes its rows and
    the ``changed`` flag (on the card in K8's one launch), and ``record``
    reads the flag on the host. The status rows are
    read on the host every ``sync_every`` steps, where the divergence check
    and the stop on full fracture run, and at the end (``sync_every`` 0:
    only there, and every step runs)."""

    def __init__(self, sync_every: int):
        self.sync_every = sync_every

    def start(self, model: FeaModel, cfg):
        dtype, dev, n = model.dtype, model.device, cfg.n_steps
        self.cfg = cfg
        self.stress = torch.zeros((n, model.n_elems), dtype=dtype, device=dev)
        self.active = torch.zeros((n, model.n_elems), dtype=torch.bool,
                                  device=dev)
        self.disp = torch.zeros((n, 3 * model.n_nodes), dtype=dtype,
                                device=dev)
        # float64 rows: the force keeps every bit it has on the device, and
        # the counts are exact
        self.status = torch.zeros((n, 4), dtype=torch.float64, device=dev)
        # the flag the post-solve writes each step
        self.changed = torch.zeros((), dtype=torch.bool, device=dev)
        self.secs = np.zeros((n,))
        self.done, self.chunk_lo, self.chunk_t0 = 0, 0, None
        return _fresh_start(model)

    def rows(self, step: int) -> PostRows:
        """The step's rows and the flag, for its post-solve to write."""
        return PostRows(self.stress[step], self.active[step],
                        self.disp[step], self.status[step], self.changed)

    def record(self, step: int, ts: float, active, out) -> bool:
        """Read whether the step's mask changed (its post-solve wrote the
        rows)."""
        if self.chunk_t0 is None:
            self.chunk_t0 = ts
        # the refresh is data-dependent: one flag a step
        with span("fea.sync.flag"):
            return bool(self.changed)

    def after(self, step: int, u_prev) -> bool:
        """Read the status where a read is due; stop on full fracture
        there."""
        self.done = step + 1
        if self.sync_every > 0 and self.done % self.sync_every == 0 \
                and self.done < self.cfg.n_steps:
            status = self._read_status()
            return status[self.done - 1, ACTIVE] == 0
        return False

    def _read_status(self) -> np.ndarray:
        """The status rows on the host; closes the chunk and checks it."""
        with span("fea.sync.status"):
            status = self.status.cpu().numpy()
        done, lo = self.done, self.chunk_lo
        if done > lo:
            self.secs[lo:done] = (time.perf_counter() - self.chunk_t0) \
                / (done - lo)
        self.chunk_lo, self.chunk_t0 = done, None
        _check_status(status, done)
        return status

    def result(self, t0: float) -> RampResult:
        status = self._read_status()
        done = self.done
        factors = np.arange(done) / (self.cfg.n_steps - 1)
        fd = np.stack([2 * self.cfg.displacement_max * factors,
                       status[:done, FORCE]], axis=1)
        with span("fea.records.fetch"):
            stress, active, disp = _fetch_records(
                (self.stress, self.active, self.disp), done)
        return RampResult(
            stress_record=stress, active_record=active, disp_record=disp,
            force_disp=fd,
            solve_seconds=self.secs[:done],
            cg_iters=status[:done, ITERS].astype(np.int64),
            total_seconds=time.perf_counter() - t0)


def _pinned_blocks() -> int:
    """Page-locked blocks the caching host allocator has made so far."""
    return torch.cuda.host_memory_stats()["allocations.allocated"]


def _fetch_records(bufs, done: int):
    """The first ``done`` rows of each device tensor of ``bufs`` as numpy
    arrays of the caller's own. CUDA rows are copied by the copy engine into
    fresh page-locked host tensors, all copies enqueued on the current
    stream and then one wait. The tensors come from PyTorch's caching host
    allocator, which hands out a freed block of the same power-of-two size
    again, so once a result of that size has been dropped a fetch page-locks
    nothing new. CPU rows are returned as ``.cpu()`` gives them."""
    if bufs[0].device.type != "cuda":
        return tuple(b[:done].cpu().numpy() for b in bufs)
    traced = profiling.on()
    if traced:
        blocks = _pinned_blocks()
    host = [torch.empty((done,) + b.shape[1:], dtype=b.dtype,
                        pin_memory=True) for b in bufs]
    for h, b in zip(host, bufs):
        h.copy_(b[:done], non_blocking=True)
    torch.cuda.current_stream(bufs[0].device).synchronize()
    if traced:
        count("fea.records.pinned_bytes", sum(h.nbytes for h in host))
        count("fea.records.pinned_fresh", _pinned_blocks() > blocks)
    return tuple(h.numpy() for h in host)


def run_ramp_async(coords, conn, cfg, device=DEFAULT_DEVICE,
                   model: Optional[FeaModel] = None,
                   sync_every: int = 8) -> RampResult:
    """The ramp with device-resident records: the per-step record pulls
    of ``run_ramp`` are replaced by one status read every ``sync_every``
    steps and one record fetch at the end. The early stop and the
    divergence check run at that granularity, and the records are cut at
    the full-fracture step as ``run_ramp`` cuts them. ``solve_seconds`` is
    chunk-amortised: each sync chunk's wall time spread evenly over its
    steps. On the card the records land in page-locked host memory that
    the result owns: the copies are complete when this returns, and a
    later pull test on the same model writes elsewhere."""
    return truncate_after_fracture(_pull_test(
        coords, conn, cfg, device, model,
        _DeviceRecords(max(int(sync_every), 1)), _ramp_steps))


def run_ramp_scan(coords, conn, cfg, device=DEFAULT_DEVICE,
                  model: Optional[FeaModel] = None) -> RampResult:
    """The ramp with no early stop and no status read before the end:
    every step runs (after full fracture the remaining solves are trivial
    identity solves) and ``solve_seconds`` is NaN, as in the reference.
    Cut the records with ``truncate_after_fracture``. Every model and
    route runs the same loop: the reference sends its large models to
    ``run_ramp`` because one compiled program for all steps is costly
    there, and no such program exists here."""
    res = _pull_test(coords, conn, cfg, device, model,
                     _DeviceRecords(0), _ramp_steps)
    return res._replace(solve_seconds=np.full((cfg.n_steps,), np.nan))
