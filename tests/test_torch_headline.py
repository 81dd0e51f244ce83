"""The port's headline bench (``mycelium_tpu_torch/bench/headline.py``, the
counterpart of the root ``bench.py``) on the host: its two configurations
equal the ones ``bench.py`` builds, field for field; the CLI with
``MYC_BENCH_SMALL`` prints one JSON line with ``bench.py``'s small key
set and the port's own keys, and refuses to run with no card unless
``--device cpu`` is given; ``run`` at small sizes gives the full key set,
309k keys that agree with a JAX cold solve and with the port's
``run_ramp`` on the same model; a part that raises makes ``run`` raise
and the CLI exit non-zero, with no line printed."""

import dataclasses
import json
import os
import subprocess
import sys

import pytest

from mycelium_tpu_torch.bench import headline
from mycelium_tpu_torch.bench.scaling import scaling_config
from mycelium_tpu_torch.meshes import synthetic_mesh
from tests import torch_support  # noqa: F401  (one torch thread)
from tests.test_torch_bench_scripts import _jax_cold_iters

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# bench.py:139-154 (MYC_BENCH_SMALL set), then the keys of bench.py:163-212
SMALL_KEYS = {"metric", "value", "unit", "vs_baseline", "bytes_per_iter",
              "bytes_total", "achieved_gbps", "roofline_frac"}
BIG_KEYS = {"solve_ms_309k", "vs_baseline_309k", "pallas_mode_309k",
            "cg_iters_309k", "achieved_gbps_309k", "roofline_frac_309k",
            "ramp_s_309k", "ramp_vs_baseline_309k", "ramp_steps_309k"}
PORT_KEYS = {"route", "impl", "device"}
N_SMALL, N_BIG = 400, 1500


def _cli(args, **env):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1", **env)
    return subprocess.run([sys.executable] + args, cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=600)


def _json_lines(stdout):
    return [json.loads(line) for line in stdout.splitlines()
            if line.startswith("{")]


@pytest.mark.parametrize("which", ["solve_22k", "ramp_309k"])
def test_configurations_equal_bench_py(which):
    """The 22k configuration against ``bench.py:98-100``'s, the ramp's
    against ``bench.py:190-194``'s on the same mesh, every field."""
    from mycelium_tpu.config import FeaConfig
    from mycelium_tpu_torch.config import hybrid_fea_config
    if which == "solve_22k":
        port = hybrid_fea_config(warm_start=False)
        ref = FeaConfig(dtype="float32", rtol=1e-6, warm_start=False,
                        operator="chain", use_pallas=True, precond="tree",
                        tree_reg_rel=1e-7)
    else:
        coords, _ = synthetic_mesh(N_BIG)
        ext = float(coords[:, 1].max() - coords[:, 1].min())
        port = headline.ramp_config(coords)
        ref = FeaConfig(dtype="float32", rtol=1e-6, operator="chain",
                        use_pallas=True, precond="tree",
                        tree_coarse_weight=0.25, tree_reg_rel=1e-7,
                        grip_length=0.3 * ext, pallas_vmem_limit_mb=120.0)
    names = {f.name for f in dataclasses.fields(port)}
    assert names == {f.name for f in dataclasses.fields(ref)}
    assert {n: getattr(port, n) for n in names} == \
        {n: getattr(ref, n) for n in names}


def test_cli_small_prints_bench_py_small_keys():
    out = _cli(["-m", "mycelium_tpu_torch.bench.headline", "--device",
                "cpu"], MYC_BENCH_SMALL="1")
    assert out.returncode == 0, out.stderr
    rows = _json_lines(out.stdout)
    assert len(rows) == 1
    row = rows[0]
    assert set(row) == SMALL_KEYS | PORT_KEYS
    assert row["metric"] == "pcg_cold_solve_22125dof_median"
    assert row["unit"] == "ms" and row["value"] > 0
    assert row["route"] == "tree_cg"
    assert row["impl"] == "torch" and row["device"] == "cpu"
    assert 0 < row["bytes_per_iter"] < row["bytes_total"]


def test_cli_without_a_card_refuses():
    out = _cli(["-m", "mycelium_tpu_torch.bench.headline"],
               MYC_BENCH_SMALL="1", CUDA_VISIBLE_DEVICES="")
    assert out.returncode != 0
    assert "no CUDA device" in out.stderr and not _json_lines(out.stdout)


def test_run_gives_the_full_keys_and_agrees_with_jax_and_run_ramp(
        monkeypatch):
    from mycelium_tpu_torch.fea.ramp import run_ramp
    monkeypatch.delenv(headline.SMALL_ENV, raising=False)
    h = headline.run("cpu", n_small=N_SMALL, n_big=N_BIG)
    row = h.row
    assert set(row) == (SMALL_KEYS | BIG_KEYS | PORT_KEYS
                        | {"route_309k"}) - {"pallas_mode_309k"}
    assert not [k for k in row if k.endswith("_error")]
    assert row["value"] == round(h.ms, 3)
    assert row["vs_baseline"] == round(164.0 / h.ms, 2)
    assert row["route_309k"] == "tree_cg"
    coords_b, conn_b = synthetic_mesh(N_BIG)
    ref = _jax_cold_iters(coords_b, conn_b, scaling_config(coords_b))
    assert row["cg_iters_309k"] >= 1
    assert abs(row["cg_iters_309k"] - ref) <= 1
    assert row["vs_baseline_309k"] == round(
        164.0 * 3 * N_BIG / 22125.0 / row["solve_ms_309k"], 2)
    assert len(h.ramps) == 1 + headline.RAMPS
    loop = run_ramp(coords_b, conn_b, h.ramp_cfg, model=h.ramp_model)
    assert row["ramp_steps_309k"] == loop.force_disp.shape[0]
    assert h.ramp_s > 0 and row["ramp_s_309k"] == round(h.ramp_s, 2)
    assert row["ramp_vs_baseline_309k"] == round(
        71.76 * 3 * N_BIG / 22125.0 / h.ramp_s, 1)


@pytest.mark.parametrize("part", ["scaling_size", "run_ramp_async"])
def test_a_failing_part_makes_run_raise(part, monkeypatch):
    from mycelium_tpu_torch.fea import ramp

    def boom(*args, **kwargs):
        raise RuntimeError(f"{part} failed")

    monkeypatch.delenv(headline.SMALL_ENV, raising=False)
    target = headline if part == "scaling_size" else ramp
    monkeypatch.setattr(target, part, boom)
    with pytest.raises(RuntimeError, match=f"{part} failed"):
        headline.run("cpu", n_small=N_SMALL, n_big=N_BIG)


FAILING_CLI = """
import runpy, sys
from mycelium_tpu_torch import meshes
from mycelium_tpu_torch.bench import scaling
full = meshes.synthetic_mesh
meshes.synthetic_mesh = lambda n: full(min(n, %d))

def boom(*args, **kwargs):
    raise RuntimeError("scaling_size failed")

scaling.scaling_size = boom
sys.argv = ["headline", "--device", "cpu"]
runpy.run_module("mycelium_tpu_torch.bench.headline", run_name="__main__")
""" % N_BIG


def test_a_failing_part_makes_the_cli_exit_non_zero(monkeypatch):
    monkeypatch.delenv(headline.SMALL_ENV, raising=False)
    out = _cli(["-c", FAILING_CLI])
    assert out.returncode != 0
    assert "scaling_size failed" in out.stderr
    assert not _json_lines(out.stdout)


def test_mesh_dir_reads_the_22k_mesh(tmp_path, monkeypatch):
    """``--mesh-dir`` (``run(mesh_dir=...)``): the 22k part solves the
    mesh of a results directory's nodes.csv and elements.csv."""
    import numpy as np
    from mycelium_tpu_torch.io import read_mesh_dir
    from mycelium_tpu_torch.io.writers import export_geometry
    coords, conn = synthetic_mesh(4000)
    export_geometry(str(tmp_path), coords[conn[:, 0]], coords[conn[:, 1]])
    monkeypatch.setenv(headline.SMALL_ENV, "1")
    h = headline.run("cpu", mesh_dir=str(tmp_path))
    want = read_mesh_dir(str(tmp_path))
    assert np.array_equal(h.coords, want[0])
    assert np.array_equal(h.conn, want[1])
    assert h.coords.shape == coords.shape and h.ramps == []
    assert set(h.row) == SMALL_KEYS | PORT_KEYS
    assert h.row["route"] == "tree_cg" and h.solve.iters >= 1
