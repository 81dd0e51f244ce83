"""The solver x preconditioner sweep (mycelium_tpu_torch/bench/sweep.py)
and ``cli sweep`` against the JAX package's.

- On scenes.test_X as tests/test_sweep_cli.py runs it (float64, 4 steps)
  and again in the configuration of scripts/bench_sweep_tpu.py (chain
  operator, tree legs with coarse weight 0.25, rtol 1e-5, max_iter 3000),
  one trial: the CSV schema and row count; per combination the sidecar's
  converged-step count equal and the median iteration count within ±1.
- The same on scenes.test_y gripped at its arm tips, where the free
  centre node moves and every leg iterates; the jacobi legs are compared
  on the reference's ELL configuration only (fault C1: its chain path runs
  block-Jacobi for them).
- ``write_sweep_results`` byte-equal to the reference's; ``trials=0``
  times nothing and records no iteration (fault C3).
- ``python -m mycelium_tpu_torch.cli sweep <dir> --device cpu`` writes
  runtime_results.csv and its sidecar."""

import dataclasses
import filecmp
import json
import os
import subprocess
import sys

import pandas as pd
import pytest

from mycelium_tpu.bench.sweep import run_solver_sweep as jsweep
from mycelium_tpu.config import FeaConfig
from mycelium_tpu.io.writers import write_sweep_results as jwrite
from mycelium_tpu_torch.bench import run_solver_sweep as tsweep
from mycelium_tpu_torch.io import export_geometry, write_sweep_results
from tests.torch_support import (jax_coarse_in_float64, random_forest_mesh,
                                 scene)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
COLUMNS = ["step", "solver", "pc", "trial", "runtime_ms", "pc_ref"]

CONFIGS = {
    # tests/test_sweep_cli.py:16-30
    "default": dict(dtype="float64", n_steps=4, displacement_max=0.004),
    # scripts/bench_sweep_tpu.py:43-45, in float64
    "chain": dict(dtype="float64", n_steps=4, displacement_max=0.004,
                  rtol=1e-5, max_iter=3000, operator="chain",
                  precond="tree", tree_coarse_weight=0.25,
                  tree_reg_rel=1e-7),
}


def _both(name, cfg, tmp_path):
    coords, conn = scene(name)
    with jax_coarse_in_float64():
        _, mj = jsweep(coords, conn, cfg, trials=1, return_meta=True,
                       out_csv=str(tmp_path / "ref.csv"))
    out = str(tmp_path / "runtime_results.csv")
    rows, mt = tsweep(coords, conn, cfg, trials=1, out_csv=out,
                      return_meta=True, device="cpu")
    df = pd.read_csv(out)
    assert list(df.columns) == COLUMNS
    assert len(df) == len(rows) == cfg.n_steps * 15
    assert set(df["solver"]) == {"cg", "bicgstab", "gmres"}
    assert set(df["pc"]) == {"tree", "coarse", "block_jacobi", "jacobi",
                             "none"}
    assert (df["runtime_ms"] > 0).all()
    with open(tmp_path / "runtime_results_meta.json") as f:
        assert json.load(f) == mt
    return mj["combos"], mt["combos"]


def _agree(cj, ct, keys):
    for k in keys:
        assert ct[k]["chain_len"] == 1 and ct[k]["steps"] == cj[k]["steps"]
        assert ct[k]["converged_steps"] == cj[k]["converged_steps"], k
        assert abs(ct[k]["median_iters"] - cj[k]["median_iters"]) <= 1, k


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sweep_matches_reference_on_test_X(config, tmp_path):
    cj, ct = _both("test_X", FeaConfig(**CONFIGS[config]), tmp_path)
    keys = [k for k in ct if not (config == "chain" and
                                  k.endswith("+jacobi"))]
    assert len(keys) == (12 if config == "chain" else 15)
    _agree(cj, ct, keys)


@pytest.mark.parametrize("config", list(CONFIGS))
def test_sweep_matches_reference_on_a_loaded_scene(config, tmp_path):
    cfg = FeaConfig(**CONFIGS[config], grip_length=0.5)
    cj, ct = _both("test_y", cfg, tmp_path)
    keys = [k for k in ct if not (config == "chain" and
                                  k.endswith("+jacobi"))]
    assert max(ct[k]["max_iters"] for k in keys) > 0
    _agree(cj, ct, keys)


def test_sweep_writer_and_no_trials(tmp_path):
    rows = [(0, "cg", "tree", 0, 1.25), (3, "gmres", "block_jacobi", 4,
                                         1234.5678901), (1, "x", "y", 0, 0.0)]
    write_sweep_results(str(tmp_path / "p.csv"), rows)
    jwrite(str(tmp_path / "r.csv"), rows)
    assert filecmp.cmp(tmp_path / "p.csv", tmp_path / "r.csv", shallow=False)
    coords, conn = scene("test_X")
    cfg = dataclasses.replace(FeaConfig(**CONFIGS["default"]), n_steps=2)
    rows, meta = tsweep(coords, conn, cfg, trials=0, return_meta=True,
                        device="cpu")
    assert rows == []
    assert all(c["steps"] == 0 and c["median_iters"] is None
               for c in meta["combos"].values())


def test_cli_sweep_writes_the_results(tmp_path):
    coords, conn = scene("test_X")
    export_geometry(str(tmp_path), coords[conn[:, 0]], coords[conn[:, 1]])
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run(
        [sys.executable, "-m", "mycelium_tpu_torch.cli", "sweep",
         str(tmp_path), "--trials", "1", "--f64", "--device", "cpu"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr
    df = pd.read_csv(tmp_path / "runtime_results.csv")
    assert list(df.columns) == COLUMNS and len(df) == 40 * 15
    with open(tmp_path / "runtime_results_meta.json") as f:
        meta = json.load(f)
    assert len(meta["combos"]) == 15


def test_sidecar_names_each_combination_route(tmp_path):
    """float32 on the chain operator, below the whole-solve tree kernel's
    gate: cg + tree (the leg and the physics solve) takes the route
    'tree_cg' as the reference's sweep takes its whole-solve tree kernel,
    cg + coarse 'chain_cg', everything else the chain path; the ell
    operator runs in node space."""
    coords, conn = random_forest_mesh(260, 8, 11)
    cfg = FeaConfig(dtype="float32", n_steps=2, displacement_max=0.004,
                    rtol=1e-5, max_iter=3000, operator="chain",
                    precond="tree", tree_coarse_weight=0.25,
                    tree_reg_rel=1e-7, grip_length=0.1)
    _, meta = tsweep(coords, conn, cfg, trials=1, return_meta=True,
                     device="cpu")
    routes = {k: v["route"] for k, v in meta["combos"].items()}
    assert routes["cg+tree"] == "tree_cg"
    assert routes["cg+coarse"] == "chain_cg"
    assert set(v for k, v in routes.items()
               if k not in ("cg+tree", "cg+coarse")) == {"hybrid"}
    assert meta["combos"]["cg+tree"]["converged_steps"] == 2
    _, meta = tsweep(coords, conn, dataclasses.replace(cfg, operator="ell"),
                     trials=1, return_meta=True, device="cpu")
    assert {v["route"] for v in meta["combos"].values()} == {"node"}
