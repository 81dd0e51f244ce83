"""The solver x preconditioner sweep (``bench/sweep.py::run_solver_sweep``,
the upstream's ``fea_petsc_solverAndPC.cpp``) as back-to-back cold solves:
unit i runs leg i mod L (the configuration's ``sweep.solvers`` x
``sweep.pcs``, in that order) on network (i // L) mod n, a closed loop of
rotations through the legs. Each unit is ``solve_displacement`` of the
intact network from x0 = 0, at a grip displacement dy drawn from the seed
uniformly in (0, ``dy_max``] (top +dy, bottom −dy), and ends when its
verdict and iterations are read on the host. No reactions, stresses,
fractures, reachability refreshes or records.

Each leg solves with the model's primary configuration (the
configuration's ``fea``, which builds the model) with ``solver``,
``precond`` and ``warm_start=False`` replaced, as ``run_solver_sweep``
builds its legs; set-up warms each leg once at dy = 0, as it does. A solve
that stops at ``max_iter`` unconverged is a completed unit (a row of the
sweep's CSV); one that raises, or returns a non-finite x, is a failed one.

Mix parameters: ``networks``, ``mesh_seeds`` (optional, as the pull-test
mix's), ``dy_max`` (mm), and under ``check`` ``per_leg`` (units judged a
leg and network, drawn from the window with the seed).
"""

from __future__ import annotations

import dataclasses
import random
import time

import numpy as np

from benchmark.harness.networks import Reservoir, build_networks, release
from benchmark.harness.trace import no_span, span
from benchmark.reference import pulltest as ref

DRAWS = 1 << 16        # displacements drawn at a time
ROUTES = ("hybrid", "chain_cg", "tree_cg")     # counted a unit
# pcg's stall exit (``fea/solve.py::pcg``, K6) calls a plateau within this
# many times its tolerance converged
STALL_ACCEPT = 10.0
# the program scales rtol by its float32 norm of the right-hand side, the
# reference by its float64 one
NORM_SLACK = 1e-3


class State:
    pass


class UnitFailed(RuntimeError):
    """A solve that raised, or returned a non-finite x."""


FAILED = (UnitFailed,)


def legs(config: dict) -> list:
    """The sweep's (solver, preconditioner) legs, in the rotation's order:
    ``solvers`` x ``pcs``."""
    sw = config["sweep"]
    return [(s, pc) for s in sw["solvers"] for pc in sw["pcs"]]


def leg_name(leg) -> str:
    return f"{leg[0]}+{leg[1]}"


def acceptance(name: str, rtol: float) -> float:
    """The largest relative |r| that leg ``name``'s solver calls converged:
    cg's stall exit accepts STALL_ACCEPT·rtol (K5, cg + coarse, has no stall
    exit), every other solver rtol."""
    solver, pc = name.split("+")
    return STALL_ACCEPT * rtol if solver == "cg" and pc != "coarse" \
        else rtol


def leg_and_network(i: int, n_legs: int, n_nets: int) -> tuple:
    """(leg, network) of unit i."""
    return i % n_legs, (i // n_legs) % n_nets


def setup(cell, seed: int, device, traced: bool) -> State:
    import torch
    from mycelium_tpu_torch.fea.ramp import refresh_anchored
    from mycelium_tpu_torch.fea.solve import solve_displacement, solve_route
    st = State()
    st.nets, st.build_s, st.mesh_s = build_networks(cell, seed, device)
    st.solve = solve_displacement
    st.span = span if traced else no_span
    st.traced = traced
    st.legs = legs(cell.config)
    st.max_iter = int(cell.config["fea"]["max_iter"])
    st.rtol = float(cell.config["fea"]["rtol"])
    st.inputs = []
    for net in st.nets:
        m = net.model
        active = torch.ones(m.n_elems, dtype=torch.bool, device=device)
        x0 = torch.zeros((m.n_nodes, 3), dtype=m.dtype, device=device)
        cfgs = [dataclasses.replace(net.cfg, solver=s, precond=pc,
                                    warm_start=False) for s, pc in st.legs]
        st.inputs.append((active, x0, refresh_anchored(m, active), cfgs,
                          [solve_route(m, c) for c in cfgs]))
    st.dy_max = float(cell.traffic["dy_max"])
    st.rng = np.random.default_rng([seed, 1])
    st.dys, st.next = [], 0
    for j in range(len(st.nets)):
        for k in range(len(st.legs)):
            _solve(st, j, k, 0.0)
    rnd = random.Random(seed)
    per_leg = int(cell.traffic["check"]["per_leg"])
    st.samples = {(j, k): Reservoir(per_leg, rnd)
                  for j in range(len(st.nets)) for k in range(len(st.legs))}
    st.counters = {"cg_iters": [], "host_s": [], "leg": []}
    st.counters.update({"route." + r: [] for r in ROUTES})
    st.routes = {}
    return st


def _solve(st: State, j: int, k: int, dy: float):
    net = st.nets[j]
    active, x0, anchored, cfgs, _ = st.inputs[j]
    try:
        with st.span("solve_displacement"):
            return st.solve(net.model, active, dy, -dy, x0, cfgs[k],
                            anchored)
    except Exception as e:
        raise UnitFailed(f"{leg_name(st.legs[k])} on network {j} at dy "
                         f"{dy} raised {e!r}") from e


def unit(st: State, i: int) -> float:
    """One cold solve of leg i mod L on its network; its host seconds."""
    import torch
    if st.next == len(st.dys):
        st.dys = (st.dy_max * (1.0 - st.rng.random(DRAWS))).tolist()
        st.next = 0
    dy = st.dys[st.next]
    st.next += 1
    k, j = leg_and_network(i, len(st.legs), len(st.nets))
    t0 = time.perf_counter()
    res = _solve(st, j, k, dy)
    dt = time.perf_counter() - t0
    if not bool(torch.isfinite(res.x).all()):
        raise UnitFailed(f"{leg_name(st.legs[k])} on network {j} at dy "
                         f"{dy} returned a non-finite x")
    route = st.inputs[j][4][k]
    c = st.counters
    c["cg_iters"].append(res.iters)
    c["host_s"].append(dt)
    c["leg"].append(k)
    for r in ROUTES:
        c["route." + r].append(int(route == r))
    slot = st.samples[(j, k)].offer()
    if slot is not None:
        # K5's and K6's result is a buffer of the model's launch: a copy
        st.samples[(j, k)].items[slot] = (dy, res.x.clone(), res.iters,
                                          res.converged, res.resnorm)
    return dt


def finish(st: State) -> None:
    if st.traced:
        # the program's route counters: its registry holds the traced
        # window alone
        from mycelium_tpu_torch.utils import profiling
        st.routes = {n: v for n, v in profiling.readings().items()
                     if n.startswith("fea.route.")}
    st.items = [(j, k, dy, x.cpu().numpy(), iters, conv, rnorm)
                for (j, k), s in st.samples.items()
                for dy, x, iters, conv, rnorm in s.items]
    st.samples = None
    st.inputs = None
    st.nets = release(st.nets)


def judge(nets: list, names: list, items: list, max_iter: int,
          rtol: float) -> dict:
    """The numbers of the judged units ``items``, (network, leg, dy, x
    (N, 3), iterations, converged, the |r| the solve reports) each, against
    the float64 reference on the intact networks ``nets``; every key for
    every leg of ``names`` (0 where no unit of the leg was judged), each the
    worst judged unit of its leg:

    - ``resid.<leg>``: how far x is from solving the reference's problem:
      |K_ff x_f + K_fk u_k| over |K_fk u_k| on the nodes the reference
      frees (``Mesh.residual``, ``Mesh.load``), and max |x − prescribed|
      over max |u_ref| on the others, the larger;
    - ``resid_gap.<leg>``: ``resid`` over the relative residual the solve
      reports (its |r| over |K_fk u_k|), that taken as at least ``rtol``:
      how far the solve's verdict overstates its x;
    - ``x_err.<leg>``: max |x − u_ref| over max |u_ref| (``solve_error``);
    - ``early_stops``: units that report not converged with fewer than
      ``max_iter`` iterations;
    - ``converged_over_tol``: units that report converged while the
      relative |r| they report is above their solver's ``acceptance``
      (with NORM_SLACK): a verdict its own |r| does not bear out;
    - ``judged``: units judged."""
    out = {"early_stops": 0, "converged_over_tol": 0, "judged": len(items)}
    for n in names:
        for key in ("resid.", "resid_gap.", "x_err."):
            out[key + n] = 0.0
    meshes = {}
    for j, k, dy, x, iters, converged, rnorm in items:
        if j not in meshes:
            net = nets[j]
            phys = ref.Physics.of(net.fields, net.fields["grip_length"])
            mesh = ref.Mesh(net.coords, net.conn, phys)
            act = np.ones(len(net.conn), bool)
            free = mesh.free(act)
            meshes[j] = (mesh, act, free, mesh.unit_pull(act))
        mesh, act, free, unit_u = meshes[j]
        x = np.asarray(x, np.float64)
        u_ref = unit_u * dy
        load = mesh.load(act, free, dy)
        pinned = np.abs(x - mesh.grips_at(dy))[~free].max(initial=0.0) \
            / np.abs(u_ref).max()
        resid = max(pinned, mesh.residual(act, free, x) / load
                    if load else 0.0)
        reported = rnorm / load if load else 0.0
        claimed = max(reported, rtol)
        got = {"resid.": resid, "resid_gap.": resid / claimed,
               "x_err.": ref.solve_error(unit_u, dy, x)}
        for key, v in got.items():
            out[key + names[k]] = max(out[key + names[k]], v)
        out["early_stops"] += int(not converged and iters < max_iter)
        out["converged_over_tol"] += int(
            converged and reported > acceptance(names[k], rtol)
            * (1.0 + NORM_SLACK))
    return out


def check(st: State) -> dict:
    """``judge``'s numbers of the judged units, beside each leg's completed
    units in the window (``units.<leg>``), their mean iterations
    (``iters.<leg>``) and host milliseconds (``ms.<leg>``), the host seconds
    of each whole rotation through the legs (``rotation_s``), and in a
    traced run the program's route counters (``fea.route.<route>``)."""
    names = [leg_name(leg) for leg in st.legs]
    out = judge(st.nets, names, st.items, st.max_iter, st.rtol)
    c = st.counters
    units = list(zip(c["leg"], c["cg_iters"], c["host_s"]))
    for k, n in enumerate(names):
        mine = [(it, s) for kk, it, s in units if kk == k]
        out["units." + n] = len(mine)
        out["iters." + n] = sum(it for it, _ in mine) / max(len(mine), 1)
        out["ms." + n] = 1e3 * sum(s for _, s in mine) / max(len(mine), 1)
    rotations, last = [], len(names)
    for k, _, s in units:
        if k <= last:         # the legs begin again
            rotations.append([])
        rotations[-1].append(s)
        last = k
    out["rotation_s"] = [sum(r) for r in rotations if len(r) == len(names)]
    out.update(st.routes)
    return out
