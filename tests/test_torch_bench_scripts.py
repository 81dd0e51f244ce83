"""The port's growth-scale and coupled bench scripts (counterparts of
``mycelium_tpu/bench/growth_scale.py`` and ``bench/coupled.py``) run on
the host with ``--device cpu`` on the demo preset (growth cut to a few
steps, to 40 in the coupled pipeline, the coupled ramp to 3) and print
one JSON line with the JAX scripts' keys, the port's own (``impl``,
``device``), and numbers that agree with the run: the stats of the growth
they time, a ramp of the steps asked for."""

import json
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GROWTH_KEYS = {"metric", "value", "unit", "segments", "hyphae",
               "total_length_mm", "wall_s", "overflow"}
COUPLED_KEYS = {"metric", "value", "unit", "vs_baseline", "segments",
                "n_dof", "growth_s", "export_s", "fea_s",
                "fea_steps_recorded", "ref_extrapolated_s"}


def _run(module, args):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-m", module] + args, cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr
    return [json.loads(line) for line in out.stdout.splitlines()
            if line.startswith("{")]


def test_growth_scale_prints_the_jax_keys():
    from mycelium_tpu_torch.config import GrowthConfig
    from mycelium_tpu_torch.growth import run_growth
    rows = _run("mycelium_tpu_torch.bench.growth_scale",
                ["demo", "--steps", "6", "--device", "cpu"])
    assert len(rows) == 1
    row = rows[0]
    assert GROWTH_KEYS | {"impl", "device"} <= row.keys()
    assert row["metric"] == "growth_steps_per_sec_demo"
    assert row["unit"] == "steps/s" and row["impl"] == "torch"
    assert row["device"] == "cpu" and row["overflow"] is False
    assert row["value"] > 0 and row["wall_s"] > 0
    assert abs(row["value"] * row["wall_s"] - 6) < 1e-6
    _, _, hist = run_growth(GrowthConfig(t_steps=6), device="cpu")
    assert (row["segments"], row["hyphae"]) == (hist[-1]["segments"],
                                                hist[-1]["hyphae"])


def test_coupled_prints_the_jax_keys():
    # 40 steps: the smallest demo growth whose network leaves the grips
    # something to solve on K6's route (20 steps does not)
    rows = _run("mycelium_tpu_torch.bench.coupled",
                ["demo", "--steps", "40", "--fea-steps", "3", "--device",
                 "cpu"])
    assert len(rows) == 1
    row = rows[0]
    assert COUPLED_KEYS | {"impl", "device", "build_s", "cold_solve_ms",
                           "cold_iters", "route"} <= row.keys()
    assert row["metric"] == "coupled_pipeline_demo" and row["unit"] == "s"
    assert row["vs_baseline"] is None and row["device"] == "cpu"
    assert row["fea_steps_recorded"] == 3 and row["n_dof"] > 0
    assert row["cold_iters"] > 0 and row["route"] == "tree_cg"
    parts = (row["growth_s"] + row["export_s"] + row["build_s"]
             + row["fea_s"])
    assert abs(row["value"] - parts) < 1e-9
    # the JAX script's estimate, scaled by the 40 steps grown
    ref = 0.75 * 40 * (row["segments"] / 2000.0) \
        + 71.76 * (row["n_dof"] / 22125.0)
    assert abs(row["ref_extrapolated_s"] - ref) <= 1e-9 * ref
