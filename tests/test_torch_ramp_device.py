"""The device-side grip reachability and the device-resident ramp loops
of the port (mycelium_tpu_torch/fea/ramp.py, fea/tree_factor.py).

- ``tree_anchored`` against ``anchored_mask_host`` (scipy connected
  components) and against the JAX package's ``tree_anchored``, and the JAX
  package's ``anchored_mask_device`` against scipy, on the four scenes and
  on random fracture masks of a forest: boolean masks, equal exactly.
- ``run_ramp_async`` (``sync_every`` 4 and 8) and ``run_ramp_scan`` +
  ``truncate_after_fracture`` against the port's ``run_ramp`` in float64:
  the same solves in the same order, so every record is equal exactly.
  Against the JAX package's ``run_ramp_async``: equal active masks,
  displacement (per-step L2), stress and force within 1e-6, the bar of
  tests/test_fea_golden.py.
- float32 below the size gate (the whole-solve route, plain version
  on the CPU): ``run_ramp_async`` equals ``run_ramp`` exactly and keeps no
  factorization.
- ``SolveDivergedError`` is raised at sync granularity.
- the CLI's ``fea --scan`` writes CSVs byte-equal to the plain ``fea`` run
  on test_I."""

import dataclasses
import filecmp
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mycelium_tpu import scenes
from mycelium_tpu.config import FeaConfig, archive_parity_config
from mycelium_tpu.fea.model import build_model as jbuild
from mycelium_tpu.fea.ramp import anchored_mask_device as j_mask_device
from mycelium_tpu.fea.ramp import run_ramp_async as j_ramp_async
from mycelium_tpu.fea.tree_jax import tree_anchored as j_tree_anchored
from mycelium_tpu.io import export_geometry
from mycelium_tpu_torch.fea import (SolveDivergedError, build_model,
                                    run_ramp, run_ramp_async, run_ramp_scan,
                                    truncate_after_fracture)
from mycelium_tpu_torch.fea import ramp as tramp
from mycelium_tpu_torch.fea.ramp import anchored_mask_host, keeps_factor
from mycelium_tpu_torch.fea.tree_factor import tree_anchored
from tests.torch_support import random_forest_mesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSVS = ("stress_record.csv", "active_elements.csv",
        "node_displacements.csv", "force_displacement.csv")
RECORDS = ("stress_record", "active_record", "disp_record", "force_disp",
           "cg_iters")


def _scene_case(name):
    sc = scenes.SCENES[name]()
    cfg = archive_parity_config(operator="chain", precond="tree",
                                **scenes.ARCHIVE_SCENE_CONFIGS[name])
    return sc.coords, sc.conn, cfg


def _forest_case(dtype="float64", rtol=1e-10):
    coords, conn = random_forest_mesh(400, 10, 2)
    ext = float(coords[:, 1].max() - coords[:, 1].min())
    cfg = FeaConfig(dtype=dtype, operator="chain", precond="tree", rtol=rtol,
                    tree_reg_rel=1e-7, grip_length=0.1 * ext,
                    displacement_max=0.05 * ext)
    return coords, conn, cfg


CASES = {**{n: (lambda n=n: _scene_case(n)) for n in scenes.SCENES},
         "forest": _forest_case}


@pytest.fixture(scope="module")
def loop_records():
    """The port's run_ramp on every case, once."""
    out = {}
    for name, case in CASES.items():
        coords, conn, cfg = case()
        model = build_model(coords, conn, cfg, "cpu")
        out[name] = (coords, conn, cfg, model,
                     run_ramp(coords, conn, cfg, model=model))
    return out


def _masks(model, fracs, seed):
    rng = np.random.default_rng(seed)
    for frac in fracs:
        yield rng.random(model.n_elems) >= frac


@pytest.mark.parametrize("name", list(CASES))
def test_device_reachability_equals_host_and_reference(name):
    coords, conn, cfg = CASES[name]()
    mt = build_model(coords, conn, cfg, "cpu")
    mj = jbuild(coords, conn, cfg)
    grip = (mt.top_nodes | mt.bot_nodes).numpy()
    fracs = (0.0, 0.05, 0.2, 0.5) if name == "forest" else (0.0, 0.3, 0.6)
    islands = 0
    for act in _masks(mt, fracs, seed=13):
        host = anchored_mask_host(np.asarray(conn), act, grip)
        islands += int((~host).sum())
        a = torch.as_tensor(act)
        np.testing.assert_array_equal(tree_anchored(mt.tree, mt, a).numpy(),
                                      host)
        np.testing.assert_array_equal(
            np.asarray(j_tree_anchored(mj.tree, mj, jnp.asarray(act))), host)
        np.testing.assert_array_equal(
            np.asarray(j_mask_device(mj, jnp.asarray(act))), host)
    if name == "forest":
        assert islands > 0, "no mask cut a node off the grips"


@pytest.mark.parametrize("name", list(CASES))
@pytest.mark.parametrize("variant", ["async4", "async8", "scan"])
def test_device_ramps_equal_the_loop_f64(loop_records, name, variant):
    coords, conn, cfg, model, loop = loop_records[name]
    assert (~loop.active_record[-1]).any(), "no element fractured"
    if variant == "scan":
        full = run_ramp_scan(coords, conn, cfg, model=model)
        assert full.force_disp.shape[0] == cfg.n_steps
        assert np.isnan(full.solve_seconds).all()
        res = truncate_after_fracture(full)
    else:
        res = run_ramp_async(coords, conn, cfg, model=model,
                             sync_every=int(variant[5:]))
        assert np.isfinite(res.solve_seconds).all()
    for field in RECORDS:
        np.testing.assert_array_equal(getattr(res, field),
                                      getattr(loop, field), err_msg=field)
    assert res.solve_seconds.shape == loop.solve_seconds.shape


@pytest.mark.parametrize("name", ["test_I", "test_X", "forest"])
def test_async_matches_reference_async_f64(loop_records, name):
    coords, conn, cfg, model, _ = loop_records[name]
    rj = j_ramp_async(coords, conn, cfg, sync_every=8)
    rt = run_ramp_async(coords, conn, cfg, model=model, sync_every=8)
    assert rt.disp_record.shape == rj.disp_record.shape
    np.testing.assert_array_equal(rt.active_record, rj.active_record)
    assert np.linalg.norm(rt.disp_record - rj.disp_record, axis=1).max() \
        < 1e-6
    s_scale = max(np.abs(rj.stress_record).max(), 1e-300)
    assert np.abs(rt.stress_record - rj.stress_record).max() < 1e-6 * s_scale
    f_scale = max(np.abs(rj.force_disp[:, 1]).max(), 1e-300)
    np.testing.assert_array_equal(rt.force_disp[:, 0], rj.force_disp[:, 0])
    assert np.abs(rt.force_disp[:, 1] - rj.force_disp[:, 1]).max() \
        < 1e-6 * f_scale


def test_whole_solve_route_keeps_no_factor(monkeypatch):
    """float32 below the gate: every solve of the ramp goes to the
    whole-solve route, no factorization is computed for it, and the
    device-resident ramp equals the loop exactly."""
    coords, conn, cfg = _forest_case("float32", 1e-6)
    model = build_model(coords, conn, cfg, "cpu")
    assert model.tree_kernel and not keeps_factor(model, cfg)
    assert keeps_factor(dataclasses.replace(model, tree_kernel=False), cfg)

    def no_factor(*a, **k):
        raise AssertionError("a factorization was computed")

    monkeypatch.setattr(tramp, "compute_tree_factor", no_factor)
    loop = run_ramp(coords, conn, cfg, model=model)
    res = run_ramp_async(coords, conn, cfg, model=model, sync_every=8)
    assert (~loop.active_record[-1]).any(), "no element fractured"
    for field in RECORDS:
        np.testing.assert_array_equal(getattr(res, field),
                                      getattr(loop, field), err_msg=field)


def test_divergence_is_raised_at_sync_granularity(monkeypatch):
    coords, conn, cfg = _forest_case()
    cfg = dataclasses.replace(cfg, max_iter=1, n_steps=12)
    model = build_model(coords, conn, cfg, "cpu")
    steps = []
    real = tramp.ramp_step

    def counting(*a, **k):
        steps.append(1)
        return real(*a, **k)

    monkeypatch.setattr(tramp, "ramp_step", counting)
    with pytest.raises(SolveDivergedError, match="step 2"):
        run_ramp_async(coords, conn, cfg, model=model, sync_every=4)
    assert len(steps) == 4          # the first status read, not step 2
    steps.clear()
    with pytest.raises(SolveDivergedError, match="step 2"):
        run_ramp_scan(coords, conn, cfg, model=model)
    assert len(steps) == 12         # no read before the end
    steps.clear()
    with pytest.raises(SolveDivergedError, match="step 2"):
        run_ramp(coords, conn, cfg, model=model)
    assert len(steps) == 2


def test_cli_scan_writes_the_same_records(tmp_path):
    sc = scenes.SCENES["test_I"]()
    kw = scenes.ARCHIVE_SCENE_CONFIGS["test_I"]
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    dirs = {}
    for tag, extra in (("loop", []), ("scan", ["--scan"])):
        d = tmp_path / tag
        export_geometry(str(d), sc.coords[sc.conn[:, 0]],
                        sc.coords[sc.conn[:, 1]])
        args = [sys.executable, "-m", "mycelium_tpu_torch.cli", "fea", str(d),
                "--f64", "--device", "cpu", "--no-plots", "--grip", "0.5",
                "--disp-max", str(kw["displacement_max"])] + extra
        out = subprocess.run(args, cwd=ROOT, env=env, capture_output=True,
                             text=True, timeout=600)
        assert out.returncode == 0, out.stderr
        dirs[tag] = d / "fea_results"
    for f in CSVS:
        assert filecmp.cmp(dirs["loop"] / f, dirs["scan"] / f,
                           shallow=False), f
    with open(dirs["scan"] / "force_displacement.csv") as f:
        assert sum(1 for _ in f) > 3
