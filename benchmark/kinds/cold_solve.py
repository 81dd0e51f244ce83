"""Back-to-back cold solves: ``solve_displacement`` of the intact network
from x0 = 0, each ending in its own stats read, at a grip displacement dy
drawn from the seed uniformly in (0, ``dy_max``] (top +dy, bottom −dy), a
closed loop over the run's networks in turn. No reactions, stresses,
fractures, reachability refreshes or records.

Mix parameters: ``networks``, ``dy_max`` (mm), and under ``check``
``solves`` (solves judged, drawn from the window with the seed).
"""

from __future__ import annotations

import random
import time

import numpy as np

from benchmark.harness.networks import Reservoir, build_networks, release
from benchmark.harness.trace import no_span, span
from benchmark.reference import pulltest as ref

DRAWS = 1 << 16        # displacements drawn at a time


class State:
    pass


class UnitFailed(RuntimeError):
    """A solve that did not converge."""


FAILED = (UnitFailed,)


def setup(cell, seed: int, device, traced: bool) -> State:
    import torch
    from mycelium_tpu_torch.fea.ramp import refresh_anchored
    from mycelium_tpu_torch.fea.solve import solve_displacement
    st = State()
    st.nets, st.build_s, st.mesh_s = build_networks(cell, seed, device)
    st.solve = solve_displacement
    st.span = span if traced else no_span
    st.inputs = []
    for net in st.nets:
        m = net.model
        active = torch.ones(m.n_elems, dtype=torch.bool, device=device)
        x0 = torch.zeros((m.n_nodes, 3), dtype=m.dtype, device=device)
        st.inputs.append((active, x0, refresh_anchored(m, active)))
    st.dy_max = float(cell.traffic["dy_max"])
    st.rng = np.random.default_rng([seed, 1])
    st.dys, st.next = [], 0
    for j, net in enumerate(st.nets):
        _solve(st, j, st.dy_max)
    st.sample = Reservoir(int(cell.traffic["check"]["solves"]),
                          random.Random(seed))
    st.counters = {"cg_iters": []}
    return st


def _solve(st: State, j: int, dy: float):
    net = st.nets[j]
    active, x0, anchored = st.inputs[j]
    with st.span("solve_displacement"):
        res = st.solve(net.model, active, dy, -dy, x0, net.cfg, anchored)
    if not res.converged:
        raise UnitFailed(f"cold solve of network {j} at dy {dy} did not "
                         f"converge: |r| {res.resnorm}")
    return res


def unit(st: State, i: int) -> float:
    """One cold solve of network i mod n; its host seconds."""
    if st.next == len(st.dys):
        st.dys = (st.dy_max * (1.0 - st.rng.random(DRAWS))).tolist()
        st.next = 0
    dy = st.dys[st.next]
    st.next += 1
    j = i % len(st.nets)
    t0 = time.perf_counter()
    res = _solve(st, j, dy)
    dt = time.perf_counter() - t0
    st.counters["cg_iters"].append(res.iters)
    slot = st.sample.offer()
    if slot is not None:
        # the result is a buffer of the model's launch: keep a copy
        st.sample.items[slot] = (j, dy, res.x.clone())
    return dt


def finish(st: State) -> None:
    st.sample.items = [(j, dy, x.cpu().numpy())
                       for j, dy, x in st.sample.items]
    st.inputs = None
    st.nets = release(st.nets)


def check(st: State) -> dict:
    """``x_err``: the worst max |x − x_ref| / max |x_ref| of the judged
    solves."""
    units = {}
    worst = 0.0
    for j, dy, x in st.sample.items:
        if j not in units:
            net = st.nets[j]
            phys = ref.Physics.of(net.fields, net.fields["grip_length"])
            mesh = ref.Mesh(net.coords, net.conn, phys)
            units[j] = mesh.unit_pull(np.ones(len(net.conn), bool))
        worst = max(worst, ref.solve_error(units[j], dy, x))
    return {"x_err": worst, "solves": len(st.sample.items)}
