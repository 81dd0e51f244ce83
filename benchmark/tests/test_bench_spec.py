"""BENCHMARK.json and the files it names: every piece is found by its name
and parses, the file keeps the benchmark's rules, a new configuration, mix
and metric are taken as new files alone, and the command refuses to run
without a card."""

import dataclasses
import json
import os
import re
import subprocess
import sys

import pytest

from conftest import ROOT, run_small
from benchmark.harness.spec import (bench_path, kind_module, load_cell,
                                    load_spec, metric_reader)

SPEC = load_spec(ROOT)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in SPEC["workloads"]]
METRICS = [m["name"] for m in SPEC["end_to_end"] + SPEC["per_layer"]]


def test_top_level_keys_and_command():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 \
        <= 43200
    assert len(json.dumps(SPEC)) <= 64 * 1024


@pytest.mark.parametrize("cell", CELLS)
def test_cell_pieces_found_by_name(cell):
    c = load_cell(ROOT, cell)
    assert c.chips == 1
    assert NAME.match(c.name) and NAME.match(c.traffic_name)
    if "mesh_seeds" in c.traffic:
        assert len(c.traffic["mesh_seeds"]) == c.traffic["networks"]
    mod = kind_module(ROOT, c.traffic["kind"])
    for fn in ("setup", "unit", "finish", "check"):
        assert callable(getattr(mod, fn))
    assert c.limits and all(v >= 0 for v in c.limits.values())
    names = {m["name"] for m in c.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in names


@pytest.mark.parametrize("name", METRICS)
def test_metric_readers_load(name):
    assert NAME.match(name)
    assert callable(metric_reader(ROOT, name))


def test_metric_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in SPEC["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= set(CELLS)
    for m in SPEC["end_to_end"] + SPEC["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline") or "_roofline." in m["name"]:
            assert m["unit"] == "%"
    assert len(set(METRICS)) == len(METRICS)


def test_configs_hold_every_field_of_the_port():
    from mycelium_tpu_torch.config import FeaConfig, GrowthConfig
    fields = {f.name for f in dataclasses.fields(FeaConfig)}
    growth = {f.name for f in dataclasses.fields(GrowthConfig)}
    files = set()
    for c in SPEC["configs"]:
        assert NAME.match(c["name"]) and c["source"].startswith("https://")
        assert len(c["why"]) <= 200 and c["reduced"] == []
        assert c["file"].startswith("benchmark/configs/")
        files.add(c["file"])
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert set(cfg["fea"]) == fields
        assert {"source", "reduced", "assumed"} <= set(cfg)
        # a network from a generator, or grown by the program
        assert "mesh" in cfg or set(cfg["growth"]) == growth
        assert len(cfg["source"]) <= 200 and cfg["reduced"] == []
    assert len(files) == len(SPEC["configs"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == {c["name"] for c in SPEC["configs"]}


def test_workload_entries():
    pairs = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
    assert len(set(CELLS)) == len(CELLS)


def test_new_config_mix_metric_and_cell_as_new_files(small_root):
    """A dummy configuration, mix, metric and limit file, and entries in
    BENCHMARK.json: the harness takes them with no file of its own
    changed."""
    root = small_root
    cfg = json.load(open(bench_path(root, "configs", "pull22k.json")))
    cfg["name"] = "dummy"
    cfg["mesh"]["n_target_nodes"] = 900
    json.dump(cfg, open(bench_path(root, "configs", "dummy.json"), "w"))
    json.dump({"kind": "cold_solve", "networks": 3, "dy_max": 0.01,
               "check": {"solves": 4}},
              open(bench_path(root, "traffic", "dummy-mix.json"), "w"))
    with open(bench_path(root, "metrics", "dummy_nodes.py"), "w") as f:
        f.write("def read(view):\n    return view.n_nodes\n")
    json.dump({"x_err": 1e-3},
              open(bench_path(root, "limits", "dummy-cell.json"), "w"))
    spec = load_spec(root)
    spec["configs"].append({"name": "dummy", "source": "https://x.org",
                            "file": "benchmark/configs/dummy.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "dummy-cell", "config": "dummy",
                              "traffic": "dummy-mix", "chips": 1,
                              "why": "a test"})
    spec["end_to_end"].append({"name": "dummy_nodes", "unit": "nodes",
                               "better": "higher", "bound": 0.01,
                               "source": "host_clock",
                               "workloads": ["dummy-cell"]})
    json.dump(spec, open(os.path.join(root, "BENCHMARK.json"), "w"))
    out = run_small(root, "dummy-cell", seconds=0.5).result
    assert out["correct"], out
    assert out["metrics"]["dummy_nodes"]["value"] == 900
    assert set(out["metrics"]) == {"dummy_nodes", "setup_s"}


def test_command_fails_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", CELLS[0],
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "no CUDA device" in out.stderr
