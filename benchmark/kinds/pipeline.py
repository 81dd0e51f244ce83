"""The upstream pipeline (``run_all.slurm``), back to back: grow a network
(``growth.step.run_growth``, its ``StepSyncs``), export it
(``growth.export.state_mesh``), build its model (``fea.model.build_model``)
and pull-test it (``fea.ramp.run_ramp_async``, records fetched to the
host), a closed loop over the mix's growth seeds in an order drawn from the
run's seed (every run does the same work). Each stage runs in a span of its
own (``STAGES``).

Mix parameters: ``growth_seeds``, ``displacement_max`` (mm, the last
step's grip displacement; it replaces the configuration's), and under
``check`` ``pipelines_per_seed`` (pipelines of each seed judged, drawn from
the window with the seed), ``growth_steps`` (steps of a judged pipeline's
growth judged: the first, the last and the rest drawn) and
``extra_segments`` (as the pull-test mix's).

After the window each judged seed's growth runs again through the same
call, its states around the judged steps and their draws copied to the host
(``growth_step`` wrapped by attribute); the reference dedups the replay's
final segments, which must give the window's network exactly. In a traced
run the replays also count K4's bytes (``metrics/anast_bytes.py``) on the
state each scan reads.
"""

from __future__ import annotations

import random
import time

import numpy as np

from benchmark.harness.cell import FLOAT_BYTES
from benchmark.harness.networks import (Network, Reservoir, fea_fields,
                                        network_seeds)
from benchmark.harness.trace import no_span, span
from benchmark.metrics.anast_bytes import step_bytes
from benchmark.reference import growth as gref
from benchmark.reference import pulltest as ref
from mycelium_tpu_torch.fea.ramp import SolveDivergedError

STAGES = ("bench.growth", "bench.export", "bench.build", "bench.ramp")


class UnitFailed(RuntimeError):
    """A growth that ran out of capacity."""


FAILED = (SolveDivergedError, UnitFailed)


class State:
    pass


def growth_seeds(traffic: dict, seed: int) -> list:
    """The mix's growth seeds in the run's order (``network_seeds``)."""
    return network_seeds({"mesh_seeds": traffic["growth_seeds"]}, seed)


def setup(cell, seed: int, device, traced: bool) -> State:
    from mycelium_tpu_torch.config import GrowthConfig
    st = State()
    st.cell, st.device, st.seed, st.traced = cell, device, seed, traced
    st.gcfg = GrowthConfig(**cell.config["growth"])
    st.dmax = float(cell.traffic["displacement_max"])
    st.seeds = growth_seeds(cell.traffic, seed)
    st.span = span if traced else no_span
    st.nets, st.build_s, st.mesh_s = [], [], []
    for s in st.seeds:                 # the warm-up: one pipeline a seed
        coords, conn, fields, _, times, _ = _pipeline(st, s)
        st.nets.append(Network(coords, conn, fields, None, None))
        st.mesh_s.append(times[0] + times[1])
        st.build_s.append(times[2])
    chk = cell.traffic["check"]
    rnd = random.Random(seed)
    st.sample = [Reservoir(int(chk["pipelines_per_seed"]), rnd)
                 for _ in st.seeds]
    st.steps, st.extra = int(chk["growth_steps"]), int(chk["extra_segments"])
    st.unit_seeds = []
    st.counters = {"growth_syncs": []}
    return st


def _pipeline(st: State, gseed: int):
    """One pipeline: (coords, conn, fea fields, the pull test's records,
    host seconds of growth, export, build and pull test, growth syncs a
    step)."""
    import torch
    from mycelium_tpu_torch.config import FeaConfig
    from mycelium_tpu_torch.fea import model as fmodel, ramp as framp
    from mycelium_tpu_torch.growth import export as gexp, step as gstep
    syncs = gstep.StepSyncs()
    t0 = time.perf_counter()
    with st.span(STAGES[0]):
        grown, _, _ = gstep.run_growth(st.gcfg, seed=gseed, device=st.device,
                                       syncs=syncs)
        if bool(grown.overflow):
            raise UnitFailed(f"growth seed {gseed} ran out of capacity")
    t1 = time.perf_counter()
    with st.span(STAGES[1]):
        coords, conn = gexp.state_mesh(grown)
    t2 = time.perf_counter()
    fields = fea_fields(st.cell.config, coords, displacement_max=st.dmax)
    cfg = FeaConfig(**fields)
    with st.span(STAGES[2]):
        model = fmodel.build_model(coords, conn, cfg, st.device)
        if st.device.type == "cuda":
            torch.cuda.synchronize(st.device)
    t3 = time.perf_counter()
    with st.span(STAGES[3]):
        res = framp.run_ramp_async(coords, conn, cfg, model=model)
    t4 = time.perf_counter()
    rec = ref.Records(res.stress_record, res.active_record, res.disp_record,
                      res.force_disp)
    return coords, conn, fields, rec, (t1 - t0, t2 - t1, t3 - t2, t4 - t3), \
        syncs.per_step


def unit(st: State, i: int) -> float:
    """One pipeline of growth seed i mod n; its host seconds."""
    j = i % len(st.seeds)
    t0 = time.perf_counter()
    coords, conn, fields, rec, _, syncs = _pipeline(st, st.seeds[j])
    dt = time.perf_counter() - t0
    slot = st.sample[j].offer()
    if slot is not None:
        st.sample[j].items[slot] = (coords, conn, fields, rec)
    st.unit_seeds.append(st.seeds[j])
    if st.traced:
        st.counters["growth_syncs"].append(syncs)
    return dt


def finish(st: State) -> None:
    import torch
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def _host(x) -> np.ndarray:
    import torch
    if x.is_floating_point():
        x = x.to(torch.float64)
    return x.detach().cpu().numpy()


def host_state(s) -> gref.State:
    """A program ``GrowthState`` on the host, its numbers in float64."""
    return gref.State(start=_host(s.start), end=_host(s.end),
                      theta=_host(s.theta), phi=_host(s.phi),
                      sub=_host(s.sub), state=_host(s.state),
                      prev=_host(s.prev), hypha=_host(s.hypha),
                      tip=_host(s.tip), n_seg=int(s.n_seg),
                      n_hyp=int(s.n_hyp), env_e=_host(s.env_e))


def host_draws(d, h_cap: int) -> gref.Draws:
    none = np.zeros((3, h_cap, 3))
    return gref.Draws(branch=_host(d.branch), ext=_host(d.ext),
                      child=_host(d.child),
                      wall_rnd=none if d.wall_rnd is None
                      else _host(d.wall_rnd),
                      wall_tan=none if d.wall_tan is None
                      else _host(d.wall_tan))


def replay(st: State, gseed: int, steps, count_bytes: bool):
    """The growth of ``gseed`` again through ``run_growth``, with
    ``growth_step`` wrapped to copy (state before, draws, state after) of
    each step in ``steps`` to the host, and ``detect_anastomosis`` to
    count each scan's bytes. Returns (those triples by step, the final
    state on the host, the bytes of every scan)."""
    from mycelium_tpu_torch.growth import step as gstep
    g = st.cell.config["growth"]
    fb = FLOAT_BYTES[g["dtype"]]
    real_step, real_scan = gstep.growth_step, gstep.detect_anastomosis
    taken, scanned = {}, [0]

    def step(s, env, cfg, draws, *args, **kwargs):
        t = s.step
        keep = t in steps
        if keep:
            before = host_state(s), host_draws(draws, s.tip.shape[0])
        out = real_step(s, env, cfg, draws, *args, **kwargs)
        if keep:
            taken[t] = before + (host_state(out),)
        return out

    def scan(s, cfg, *args, **kwargs):
        h = host_state(s)
        scanned[0] += step_bytes(h.start, h.end, h.state, h.tip, h.n_hyp,
                                 h.n_seg, g, fb)
        return real_scan(s, cfg, *args, **kwargs)

    gstep.growth_step = step
    if count_bytes:
        gstep.detect_anastomosis = scan
    try:
        final, _, _ = gstep.run_growth(st.gcfg, seed=gseed, device=st.device)
    finally:
        gstep.growth_step, gstep.detect_anastomosis = real_step, real_scan
    return taken, host_state(final), scanned[0]


def merge_worst(worst: dict, got: dict) -> None:
    """Each number's worst into ``worst``; ``steps`` judged are added."""
    for k, v in got.items():
        worst[k] = v + worst.get(k, 0) if k == "steps" \
            else max(v, worst.get(k, v))


def check(st: State) -> dict:
    """The worst of each number over the judged pipelines: the growth's
    judged steps (``reference/growth.py::judge``), the export
    (``mesh_off``) and the pull test (``reference/pulltest.py::check_ramp``
    on the program's network)."""
    rng = np.random.default_rng([st.seed, 2])
    g = st.cell.config["growth"]
    t_steps = int(g["t_steps"])
    inner = list(range(1, t_steps - 1))
    worst = {}
    per_seed = {}
    for j, gseed in enumerate(st.seeds):
        items = st.sample[j].items
        if not items:             # the seed ran no pipeline in the window
            continue
        k = min(st.steps - 2, len(inner))
        steps = sorted({0, t_steps - 1} | set(
            rng.choice(inner, k, replace=False).tolist()))
        taken, final, per_seed[gseed] = replay(st, gseed, set(steps),
                                               st.traced)
        for t in steps:
            merge_worst(worst, gref.judge(*taken[t], g))
        ref_coords, ref_conn = gref.mesh(final.start, final.end, final.state,
                                         final.hypha)
        for coords, conn, fields, rec in items:
            merge_worst(worst, {"mesh_off": gref.mesh_off(
                coords, conn, ref_coords, ref_conn)})
            phys = ref.Physics.of(fields, fields["grip_length"])
            merge_worst(worst, ref.check_ramp(
                ref.Mesh(coords, conn, phys), st.dmax, rec, rng, st.extra))
    if st.traced:
        st.counters["anast_bytes"] = [per_seed.get(s, 0)
                                      for s in st.unit_seeds]
    return worst
