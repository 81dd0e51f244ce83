"""The solver sweep's kind (``kinds/solver_sweep.py``) on the CPU at a small
size, in a copy of the benchmark that adds a sweep cell of every leg:

- unit i runs leg i mod L on network (i // L) mod n, each leg with the
  primary configuration's solver and preconditioner replaced;
- one unit a leg and network is judged;
- a solve that stops at ``max_iter`` unconverged completes its unit, one
  that stops before it is an early stop, one that raises or returns a
  non-finite x is a failed unit;
- ``solve_ms`` reads both cold-solve kinds, and every reader of the cells
  reads what it read before the kind was added (``PARENT_SOLVE_MS``,
  ``PARENT_METRICS``);
- planted faults move their numbers: x scaled by (1 + 1e-3) ``x_err``, a
  leg stopped at 300 iterations with its verdict read as unconverged
  ``early_stops``, the same read as converged ``converged_over_tol``;
- the control side (``control.py``) judges the TF32 reference's rotation.
"""

import dataclasses
import json
import math
import os
import types

import pytest
import torch

from conftest import ROOT, copy_benchmark, run_small
from benchmark.harness.spec import kind_module, load_cell, metric_reader

CELL = "sweep-test"
SEED = 2**33 + 11
SOLVERS = ("cg", "bicgstab", "gmres")
PCS = ("tree", "coarse", "block_jacobi", "jacobi", "none")
LEGS = [(s, p) for s in SOLVERS for p in PCS]
# the sweep's solver settings (scripts/bench_sweep_tpu.py) on pull22k's fea
SWEEP_FEA = {"rtol": 1e-5, "max_iter": 3000, "tree_coarse_weight": 0.25,
             "warm_start": False}
TRAFFIC = {"kind": "solver_sweep", "networks": 1, "mesh_seeds": [0],
           "dy_max": 0.02, "check": {"per_leg": 1}}


def _kind():
    return kind_module(ROOT, "solver_sweep")


def _sweep_root(dst: str, nodes: int) -> str:
    """A copy of the benchmark with ``nodes``-node networks and the cell
    ``CELL``: pull22k's network and physics at the sweep's settings, every
    leg, one network."""
    root = copy_benchmark(dst, nodes)
    cfg = json.load(open(os.path.join(root, "benchmark/configs/pull22k.json")))
    cfg["fea"].update(SWEEP_FEA)
    cfg["sweep"] = {"solvers": list(SOLVERS), "pcs": list(PCS)}
    json.dump(cfg, open(os.path.join(root, "benchmark/configs/sweep.json"),
                        "w"))
    json.dump(TRAFFIC, open(os.path.join(
        root, "benchmark/traffic/sweep-test.json"), "w"))
    json.dump({}, open(os.path.join(root, "benchmark/limits", CELL + ".json"),
                       "w"))
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["configs"].append({"name": "sweep", "file":
                            "benchmark/configs/sweep.json"})
    spec["workloads"].append({"name": CELL, "config": "sweep",
                              "traffic": "sweep-test", "chips": 1})
    spec["end_to_end"] = [dict(m, workloads=m["workloads"] + [CELL])
                          if m["name"] == "solve_ms" else m
                          for m in spec["end_to_end"]]
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    return root


def _small_cell(tmp_path, nodes=600, **traffic):
    cell = load_cell(_sweep_root(str(tmp_path), nodes), CELL)
    return cell._replace(traffic=dict(cell.traffic, **traffic))


def _patch_solve(monkeypatch, change, caps=None):
    """The program's solve as the sweep calls it, with ``max_iter`` set to
    ``caps[leg]`` for the legs ``caps`` names and its result passed through
    ``change(res, cfg)``."""
    from mycelium_tpu_torch.fea import solve
    real = solve.solve_displacement

    def patched(model, active, dy_top, dy_bot, x0, cfg, anchored=None,
                **kw):
        cap = (caps or {}).get(f"{cfg.solver}+{cfg.precond}")
        if cap is not None:
            cfg = dataclasses.replace(cfg, max_iter=cap)
        return change(real(model, active, dy_top, dy_bot, x0, cfg,
                           anchored, **kw), cfg)

    monkeypatch.setattr(solve, "solve_displacement", patched)


def _units(cell, n, seed=SEED):
    kind = _kind()
    st = kind.setup(cell, seed, torch.device("cpu"), False)
    for i in range(n):
        kind.unit(st, i)
    kind.finish(st)
    return st, kind.check(st)


def test_unit_order():
    kind = _kind()
    got = [kind.leg_and_network(i, 15, 2) for i in range(60)]
    assert got[:16] == [(k, 0) for k in range(15)] + [(0, 1)]
    assert got[30:45] == [(k, 0) for k in range(15)]
    config = {"sweep": {"solvers": list(SOLVERS), "pcs": list(PCS)}}
    assert kind.legs(config) == LEGS


def test_acceptance():
    kind = _kind()
    got = {f"{s}+{p}": kind.acceptance(f"{s}+{p}", 1e-5) for s, p in LEGS}
    # cg's stall exit, but not K5's (cg + coarse), which has none
    assert {n for n, a in got.items() if a == pytest.approx(1e-4)} == \
        {"cg+tree", "cg+block_jacobi", "cg+jacobi", "cg+none"}
    assert all(a == 1e-5 for n, a in got.items()
               if n not in ("cg+tree", "cg+block_jacobi", "cg+jacobi",
                            "cg+none"))


def test_units_run_each_leg_on_its_network(tmp_path, monkeypatch):
    torch.set_num_threads(1)
    calls = []

    def record(res, cfg):
        calls.append((cfg.solver, cfg.precond, cfg.warm_start))
        return res

    _patch_solve(monkeypatch, record)
    cell = _small_cell(tmp_path, networks=2, mesh_seeds=[0, 1])
    st, out = _units(cell, 30)
    # set-up warms each leg of each network once, in the rotation's order
    assert calls == [(s, p, False) for s, p in LEGS] * 4
    assert out["judged"] == 30
    assert all(out["units." + f"{s}+{p}"] == 2 for s, p in LEGS)
    assert sorted((j, k) for j, k, *_ in st.items) == \
        [(j, k) for j in range(2) for k in range(15)]
    routes = st.counters
    assert sum(routes["route.tree_cg"]) == 2
    assert sum(routes["route.chain_cg"]) == 2
    assert sum(routes["route.hybrid"]) == 26
    assert len(out["rotation_s"]) == 2


def test_one_judged_unit_a_leg(tmp_path):
    torch.set_num_threads(1)
    st, out = _units(_small_cell(tmp_path), 45)
    assert out["judged"] == 15
    assert sorted(k for _, k, *_ in st.items) == list(range(15))
    for s, p in LEGS:
        n = f"{s}+{p}"
        assert out["units." + n] == 3
        assert out["resid." + n] > 0 and out["x_err." + n] > 0
    assert len(out["rotation_s"]) == 3


@pytest.mark.parametrize("iters,early", [(None, 0), (-1, 1)])
def test_unconverged_at_max_iter_completes(tmp_path, monkeypatch, iters,
                                           early):
    """A solve reported unconverged at ``max_iter`` iterations completes
    its unit; one reported unconverged before it is an early stop."""
    torch.set_num_threads(1)

    def stop(res, cfg):
        if (cfg.solver, cfg.precond) != ("cg", "none"):
            return res
        n = cfg.max_iter if iters is None else cfg.max_iter + iters
        return dataclasses.replace(res, iters=n, converged=False)

    _patch_solve(monkeypatch, stop)
    st, out = _units(_small_cell(tmp_path), 15)
    assert out["units.cg+none"] == 1
    assert out["early_stops"] == early


@pytest.mark.parametrize("fault", ["nan", "raise"])
def test_failed_solve_is_a_failed_unit(tmp_path, fault):
    torch.set_num_threads(1)
    cell = _small_cell(tmp_path)
    kind = _kind()
    st = kind.setup(cell, SEED, torch.device("cpu"), False)

    def broken(res, cfg):
        if fault == "raise":
            raise RuntimeError("planted")
        return dataclasses.replace(res, x=res.x * math.nan)

    real = st.solve
    st.solve = lambda *a, **kw: broken(real(*a, **kw), a[5])
    with pytest.raises(kind.FAILED):
        kind.unit(st, 0)


def _view(kind, units=4):
    return types.SimpleNamespace(kind=kind, unit_s=[0.25] * units,
                                 window_s=2.0, counters={}, trace=None,
                                 peaks=None, plan_build_s=[0.5])


def PARENT_SOLVE_MS(view):
    """``metrics/solve_ms.py::read`` before the sweep's kind."""
    if view.kind != "cold_solve" or not view.unit_s:
        return None
    return 1e3 * view.window_s / len(view.unit_s)


@pytest.mark.parametrize("kind", ["cold_solve", "solver_sweep", "pull_test",
                                  "pipeline"])
@pytest.mark.parametrize("units", [0, 3])
def test_solve_ms_reads_both_cold_solve_kinds(kind, units):
    read = metric_reader(ROOT, "solve_ms")
    got = read(_view(kind, units))
    if kind == "solver_sweep" and units:
        assert got == pytest.approx(1e3 * 2.0 / units)
    else:
        assert got == PARENT_SOLVE_MS(_view(kind, units))


# each cell's metrics before the sweep's kind: (end-to-end, per-layer)
PARENT_METRICS = {
    "pull309k-fracture": (
        ["pulltest_s", "setup_s"],
        ["refresh_ms.ramp", "post_solve_ms.ramp", "pulltest_tail_s.fracture",
         "solve_roofline.ramp", "device_idle.ramp", "plan_build_s",
         "refresh_trips.ramp", "refresh_host_ms.ramp", "syncs.ramp",
         "sync_wait_ms.ramp", "records_ms.ramp", "cg_iters.ramp"]),
    "pull22k-cold": (
        ["solve_ms", "setup_s"],
        ["solve_roofline.cold", "dispatch_ms.cold", "cg_iters.cold",
         "device_idle.cold", "plan_build_s", "launch_ms.cold",
         "sync_wait_ms.cold"]),
    "pull309k-ramp": (
        ["pulltest_s", "setup_s"],
        ["refresh_ms.ramp", "post_solve_ms.ramp", "solve_roofline.ramp",
         "device_idle.ramp", "plan_build_s", "refresh_trips.ramp",
         "refresh_host_ms.ramp", "syncs.ramp", "sync_wait_ms.ramp",
         "records_ms.ramp", "cg_iters.ramp"]),
    "pipeline-demo": (
        ["setup_s", "pipeline_s"],
        ["growth_s.pipeline", "growth_device_ms.pipeline",
         "growth_syncs.pipeline", "anast_roofline.pipeline",
         "build_s.pipeline", "ramp_s.pipeline", "device_idle.pipeline",
         "export_s.pipeline", "build_plan_s.pipeline", "k6_solves.pipeline",
         "solve_roofline.pipeline"]),
}
PARENT_METRICS["pipeline-xlarge"] = PARENT_METRICS["pipeline-demo"]
# the one metric added to a cell that was there: the pipeline cells fill
# plan_build_s in set-up
ADDED = {"pipeline-demo": {"plan_build_s"},
         "pipeline-xlarge": {"plan_build_s"}}


@pytest.mark.parametrize("cell", sorted(PARENT_METRICS))
def test_existing_cells_report_what_they_did(cell):
    c = load_cell(ROOT, cell)
    e2e, per_layer = PARENT_METRICS[cell]
    assert [m["name"] for m in c.end_to_end] == e2e
    got = [m["name"] for m in c.per_layer]
    assert set(got) == set(per_layer) | ADDED.get(cell, set())
    assert [n for n in got if n in per_layer] == per_layer


@pytest.fixture(scope="module")
def saved_views(tmp_path_factory):
    """The RunView of one small untraced run of each cell that was there
    before the sweep's kind, on the CPU."""
    import benchmark.harness.cell as cell_mod
    root = copy_benchmark(str(tmp_path_factory.mktemp("views")), 600)
    views = {}
    real = cell_mod.RunView
    try:
        for cell in sorted(PARENT_METRICS):
            got = []

            def keep(**kw):
                got.append(real(**kw))
                return got[-1]

            cell_mod.RunView = keep
            run_small(root, cell, seconds=0.2)
            views[cell] = got[0]
    finally:
        cell_mod.RunView = real
    return views


@pytest.mark.parametrize("cell", sorted(PARENT_METRICS))
def test_existing_cells_read_the_same(saved_views, cell):
    """On each cell's saved run, ``solve_ms`` reads as its parent did,
    every other end-to-end reader of the cell is a file the sweep's kind
    did not change, and ``plan_build_s`` reads in every cell that lists
    it."""
    view = saved_views[cell]
    read = metric_reader(ROOT, "solve_ms")
    assert read(view) == PARENT_SOLVE_MS(view)
    if cell == "pull22k-cold":
        assert read(view) is not None
    for name in PARENT_METRICS[cell][0]:
        metric_reader(ROOT, name)(view)
    assert metric_reader(ROOT, "plan_build_s")(view) > 0


def _scaled(res, cfg):
    return dataclasses.replace(res, x=res.x * (1.0 + 1e-3))


def _stopped(res, cfg):
    return res


def _claimed(res, cfg):
    """A verdict of converged whatever |r| reads: a stall exit that takes
    any plateau."""
    return dataclasses.replace(res, converged=True)


PLANTED = {
    # x scaled by (1 + 1e-3): x_err reads 1e-3 on the tree legs
    "scaled": (_scaled, {}, "x_err.cg+tree"),
    # cg + none stopped at 300 iterations, its verdict read as unconverged
    "stopped": (_stopped, {"cg+none": 300}, "early_stops"),
    # the same stop read as converged
    "claimed": (_claimed, {"cg+none": 300}, "converged_over_tol"),
}


@pytest.fixture(scope="module")
def sound(tmp_path_factory):
    """One rotation at 1,500 nodes (cg + none takes ~390 iterations there)
    with no fault."""
    torch.set_num_threads(1)
    return _units(load_cell(_sweep_root(str(
        tmp_path_factory.mktemp("sound")), 1500), CELL), 15)[1]


def test_sound_rotation_reads_no_fault(sound):
    assert sound["early_stops"] == 0
    assert sound["converged_over_tol"] == 0
    assert sound["x_err.cg+tree"] < 1e-4
    assert sound["iters.cg+none"] > 300


@pytest.mark.parametrize("fault", sorted(PLANTED))
def test_planted_fault_moves_its_number(tmp_path, monkeypatch, sound, fault):
    torch.set_num_threads(1)
    change, caps, key = PLANTED[fault]
    _patch_solve(monkeypatch, change, caps)
    out = _units(load_cell(_sweep_root(str(tmp_path), 1500), CELL), 15)[1]
    if fault == "scaled":
        assert out[key] == pytest.approx(1e-3, rel=0.05)
    else:
        assert out[key] == 1 and sound[key] == 0


def test_run_of_the_kind(tmp_path):
    """A whole run through the harness reports ``solve_ms`` and every
    number ``judge`` gives, for every leg."""
    out = run_small(_sweep_root(str(tmp_path), 600), CELL, seconds=0.5)
    assert out.result["failed"] == 0
    assert out.result["metrics"]["solve_ms"]["value"] > 0
    numbers = [n for n in out.notes if n.startswith("numbers ")][0]
    for s, p in LEGS:
        for key in ("resid.", "resid_gap.", "x_err.", "units."):
            assert f"'{key}{s}+{p}'" in numbers


def test_control_judges_the_tf32_rotation(tmp_path):
    """``control.py``'s sweep branch: the TF32 reference's x for every leg
    of the first rotation, judged by the kind's ``judge``; it claims no
    |r|, so only the distance of its x counts."""
    from benchmark import control
    cell = load_cell(_sweep_root(str(tmp_path), 600), CELL)
    got = control.control(cell, SEED)
    assert got["judged"] == 15
    assert got["early_stops"] == 0 and got["converged_over_tol"] == 0
    for s, p in LEGS:
        assert 0 < got[f"x_err.{s}+{p}"] < 1e-2
