"""The xlarge pipeline deployment (``benchmark/configs/pipeline-xlarge.json``)
on the CPU, at 3x3 sites:

- a dish of the xlarge preset's shape (its per-site settings, its 0.5 mm
  spacing and its margin to the wall, omega0 scaled by the sites, its
  segment slots and hyphae a site) grown through ``run_growth`` in
  float64, every step judged by the plain growth reference
  (``benchmark/reference/growth.py::judge``) at float64 rounding, as
  ``benchmark/tests/test_bench_pipeline.py`` holds it: far inside the
  cell's float32 limits, so a dropped snap or a skipped branching fails;
  then exported, built and pulled 40 steps in the cell's float32, the
  pull judged by ``benchmark/reference/pulltest.py::check_ramp`` within
  the cell's limits (``benchmark/limits/pipeline-xlarge.json``);
- the program's spans and counters of a pipeline under a CPU
  ``torch.profiler``: one ``growth.export``, one ``fea.build`` with its
  four children inside it, one ``fea.route.*`` a ``fea.solve``, the solved
  nodes and elements a solve; nothing with the profiler off;
- ``tree_kernel_fits`` on each side of K6's memory guard."""

import dataclasses
import json
import os

import numpy as np
import pytest
from torch.profiler import ProfilerActivity, profile

import tests.torch_support  # noqa: F401  (one torch thread a worker)
from benchmark.kinds.pipeline import host_draws, host_state
from benchmark.reference import growth as gref
from benchmark.reference import pulltest as ref
from mycelium_tpu_torch.config import FeaConfig, GrowthConfig
from mycelium_tpu_torch.fea import model as fmodel
from mycelium_tpu_torch.fea.ramp import run_ramp_async
from mycelium_tpu_torch.growth import step as gstep
from mycelium_tpu_torch.growth.export import state_mesh
from mycelium_tpu_torch.kernels.tree_cg import TreeCgLaunch
from mycelium_tpu_torch.utils import profiling

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG = json.load(open(os.path.join(
    ROOT, "benchmark", "configs", "pipeline-xlarge.json")))
LIMITS = json.load(open(os.path.join(
    ROOT, "benchmark", "limits", "pipeline-xlarge.json")))
SITES = 3
STEPS = 30
DMAX = 0.02


def small_dish() -> dict:
    """The xlarge preset's growth fields at SITES x SITES sites: the same
    spacing and margin to the wall, omega0 a site, and capacity a site
    (2^21 slots and 2^18 hyphae for 66 x 66 sites: ~481 and ~60 a site)."""
    g = dict(CONFIG["growth"])
    n_x, gap = g["inoculum_nx"], g["dist_inoculum"]
    margin = (g["dish_size"] - (n_x - 1) * gap) / 2
    dish = (SITES - 1) * gap + 2 * margin
    sites = SITES * SITES
    per_site = g["omega0"] / (n_x * g["inoculum_ny"])
    g.update(inoculum_nx=SITES, inoculum_ny=SITES, dish_size=dish,
             substrate_width=dish, omega0=per_site * sites, t_steps=STEPS,
             max_segments=1 << 12, max_hyphae=1 << 9, dtype="float64")
    return g


@pytest.fixture(scope="module")
def grown():
    """(growth fields, the worst of each judged number over every step,
    the final state, what the dish did) of seed 42."""
    g = small_dish()
    cfg = GrowthConfig(**g)
    real = gstep.growth_step
    worst, seen = {}, {"branches": 0, "snaps": 0}

    def step(s, env, c, draws, *args, **kwargs):
        before = host_state(s)
        d = host_draws(draws, s.tip.shape[0])
        out = real(s, env, c, draws, *args, **kwargs)
        after = host_state(out)
        for k, v in gref.judge(before, d, after, g).items():
            worst[k] = max(v, worst.get(k, v))
        seen["branches"] += after.n_hyp - before.n_hyp
        seen["snaps"] += int(np.sum((after.state == gref.ANASTOMOSED)
                                    & (before.state != gref.ANASTOMOSED)))
        return out

    gstep.growth_step = step
    try:
        final, _, _ = gstep.run_growth(cfg, seed=42, device="cpu")
    finally:
        gstep.growth_step = real
    return g, worst, final, seen


def fea_config(coords) -> FeaConfig:
    """The cell's FEA fields, grips 0.3 of the network's y extent (the
    cell's 1.5 mm grips would hold the whole of so small a dish)."""
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    return FeaConfig(**dict(CONFIG["fea"], grip_length=0.3 * ext,
                            displacement_max=DMAX))


def test_small_dish_keeps_the_preset_shape():
    g = small_dish()
    assert g["dish_size"] == pytest.approx(3.5)
    assert g["omega0"] == pytest.approx(5e-6 * SITES * SITES / 25)
    per_site = CONFIG["growth"]["max_segments"] / 66 ** 2
    assert 0.8 < g["max_segments"] / SITES ** 2 / per_site < 1.2


def test_growth_judged_every_step_within_the_limits(grown):
    g, worst, final, seen = grown
    assert not bool(final.overflow)
    assert seen["branches"] > 0 and seen["snaps"] > 0, seen
    assert worst["growth_pos_err"] < 1e-12
    assert worst["growth_sub_err"] < 1e-12
    assert worst["growth_env_err"] < 1e-12
    assert worst["growth_off"] == 0 and worst["growth_margin"] == 0


def test_exported_built_and_pulled_within_the_limits(grown):
    g, _, final, _ = grown
    coords, conn = state_mesh(final)
    h = host_state(final)
    ref_coords, ref_conn = gref.mesh(h.start, h.end, h.state, h.hypha)
    assert gref.mesh_off(coords, conn, ref_coords, ref_conn) \
        <= LIMITS["mesh_off"]
    cfg = fea_config(coords)
    model = fmodel.build_model(coords, conn, cfg, "cpu")
    assert model.tree_kernel
    res = run_ramp_async(coords, conn, cfg, model=model)
    assert res.force_disp.shape[0] == cfg.n_steps
    rec = ref.Records(res.stress_record, res.active_record, res.disp_record,
                      res.force_disp)
    fields = dataclasses.asdict(cfg)
    got = ref.check_ramp(
        ref.Mesh(coords, conn, ref.Physics.of(fields, cfg.grip_length)),
        DMAX, rec, np.random.default_rng(0), 6)
    for k in ("residual", "stress_err", "force_err", "fracture_margin",
              "records_off"):
        assert got[k] <= LIMITS[k], (k, got[k])


@pytest.fixture(scope="module")
def readings(grown):
    """(untraced readings, traced readings, the model, the pull test's
    steps) of one export, build and pull test of 10 steps."""
    _, _, final, _ = grown
    profiling.reset_readings()
    coords, conn = state_mesh(final)
    cfg = dataclasses.replace(fea_config(coords), n_steps=10)
    model = fmodel.build_model(coords, conn, cfg, "cpu")
    run_ramp_async(coords, conn, cfg, model=model)
    off = profiling.readings()
    with profile(activities=[ProfilerActivity.CPU]):
        coords, conn = state_mesh(final)
        model = fmodel.build_model(coords, conn, cfg, "cpu")
        res = run_ramp_async(coords, conn, cfg, model=model)
    on = profiling.readings()
    profiling.reset_readings()
    return off, on, model, res.force_disp.shape[0]


def test_no_profiler_no_pipeline_readings(readings):
    assert readings[0] == {}


def test_export_and_build_spans(readings):
    _, on, _, _ = readings
    assert on["growth.export"]["count"] == 1
    assert on["fea.build"]["count"] == 1
    kids = ("fea.build.schedule", "fea.build.chain", "fea.build.tree",
            "fea.build.kernels")
    for k in kids:
        assert on[k]["count"] == 1, k
    assert 0 < sum(on[k]["host_s"] for k in kids) \
        <= on["fea.build"]["host_s"]


def test_route_and_size_counters(readings):
    _, on, model, steps = readings
    solves = on["fea.solve"]["count"]
    assert solves == steps
    routes = {k: v for k, v in on.items() if k.startswith("fea.route.")}
    assert sum(routes.values()) == solves
    assert routes == {"fea.route.tree_cg": solves}
    assert on["fea.solve.nodes"] == solves * model.n_nodes
    assert on["fea.solve.elems"] == solves * model.n_elems


@pytest.mark.parametrize("over", [False, True])
def test_tree_kernel_fits_at_the_guard(grown, monkeypatch, over):
    _, _, final, _ = grown
    coords, conn = state_mesh(final)
    cfg = fea_config(coords)
    model = fmodel.build_model(coords, conn, cfg, "cpu")
    nbytes = fmodel.TREE_KERNEL_MAX_BYTES + (1 if over else 0)
    monkeypatch.setattr(TreeCgLaunch, "nbytes", lambda self: nbytes)
    assert fmodel.tree_kernel_bytes(model) == nbytes
    assert fmodel.tree_kernel_fits(model) is not over
    assert fmodel.with_kernels(model).tree_kernel is not over
