"""Back-to-back pull tests: the 40-step quasi-static ramp
(``run_ramp_async``, warm starts, records fetched to the host at the end),
a closed loop over the run's networks in turn.

Mix parameters: ``networks``, ``displacement_max`` (mm, the last step's
grip displacement; it replaces the configuration's), and under ``check``
``tests_per_network`` (pull tests of each network judged, drawn from the
window with the seed) and ``extra_segments`` (runs of steps between
fractures judged beside the first and the last, drawn with the seed).
"""

from __future__ import annotations

import random
import time

import numpy as np

from benchmark.harness.networks import Reservoir, build_networks, release
from benchmark.reference import pulltest as ref
from mycelium_tpu_torch.fea.ramp import SolveDivergedError

FAILED = (SolveDivergedError,)


class State:
    pass


def setup(cell, seed: int, device, traced: bool) -> State:
    from mycelium_tpu_torch.fea.ramp import run_ramp_async
    st = State()
    st.dmax = float(cell.traffic["displacement_max"])
    st.nets, st.build_s, st.mesh_s = build_networks(cell, seed, device,
                                         displacement_max=st.dmax)
    st.run = run_ramp_async
    for net in st.nets:
        st.run(net.coords, net.conn, net.cfg, model=net.model)
    chk = cell.traffic["check"]
    rnd = random.Random(seed)
    st.sample = [Reservoir(int(chk["tests_per_network"]), rnd)
                 for _ in st.nets]
    st.extra = int(chk["extra_segments"])
    st.seed = seed
    st.traced = traced
    st.counters = {"fracture_steps": []}
    return st


def unit(st: State, i: int) -> float:
    """One pull test of network i mod n; its host seconds."""
    j = i % len(st.nets)
    net = st.nets[j]
    t0 = time.perf_counter()
    res = st.run(net.coords, net.conn, net.cfg, model=net.model)
    dt = time.perf_counter() - t0
    slot = st.sample[j].offer()
    if slot is not None:
        st.sample[j].items[slot] = res
    if st.traced:
        # steps after which fewer elements are active (masks only shrink)
        n_act = res.active_record.sum(axis=1)
        st.counters["fracture_steps"].append(int(np.count_nonzero(
            np.diff(n_act, prepend=res.active_record.shape[1]))))
    return dt


def finish(st: State) -> None:
    st.nets = release(st.nets)


def check(st: State) -> dict:
    """The worst of each number over the judged pull tests."""
    rng = np.random.default_rng([st.seed, 2])
    worst = {}
    for net, res in zip(st.nets, st.sample):
        phys = ref.Physics.of(net.fields, net.fields["grip_length"])
        mesh = ref.Mesh(net.coords, net.conn, phys)
        for r in res.items:
            got = ref.check_ramp(mesh, st.dmax, ref.Records(
                r.stress_record, r.active_record, r.disp_record,
                r.force_disp), rng, st.extra)
            for k, v in got.items():
                worst[k] = v + worst.get(k, 0) if k == "steps" \
                    else max(v, worst.get(k, v))
    return worst
