"""Finding the pieces of a cell by name.

``BENCHMARK.json`` (at the root the benchmark runs from) names each cell's
configuration and traffic mix. The files are found by those names:

- ``<config file>`` as the ``configs`` entry gives it: the deployment (the
  mesh generator and its arguments, every ``FeaConfig`` field, ``source``,
  ``reduced``, ``assumed``);
- ``benchmark/traffic/<traffic>.json``: the mix's parameters, whose
  ``kind`` names the driver ``benchmark/kinds/<kind>.py``;
- ``benchmark/metrics/<metric>.py``: one reader a metric, end-to-end or
  per-layer, with ``read(view)`` returning a number or None;
- ``benchmark/limits/<cell>.json``: the limit of each number the
  comparison with the reference reads in that cell.

A later cell, mix, metric or kind is a new file; no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import NamedTuple

BENCH_DIR = "benchmark"


class Cell(NamedTuple):
    root: str              # where BENCHMARK.json is
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    end_to_end: list       # the BENCHMARK.json entries this cell reports
    per_layer: list
    limits: dict


def bench_path(root: str, *parts: str) -> str:
    return os.path.join(root, BENCH_DIR, *parts)


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: str) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(root: str, name: str) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json, its files read."""
    spec = load_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json: "
                       f"{sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[w["config"]]
    return Cell(
        root=root, name=name, chips=int(w["chips"]),
        config_name=w["config"],
        config=load_json(os.path.join(root, cfg_entry["file"])),
        traffic_name=w["traffic"],
        traffic=load_json(bench_path(root, "traffic",
                                     w["traffic"] + ".json")),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)],
        limits=load_json(bench_path(root, "limits", name + ".json")))


def load_module(path: str, name: str):
    """The Python file ``path`` as a module (a metric's name may hold dots,
    so it is loaded by path and not imported by name)."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(root: str, name: str):
    """``read(view)`` of the metric ``name``."""
    return load_module(bench_path(root, "metrics", name + ".py"),
                       "bench_metric_" + name.replace(".", "_")).read


def kind_module(root: str, kind: str):
    """The traffic driver ``kind``: ``setup``, ``unit``, ``release``,
    ``check``."""
    return load_module(bench_path(root, "kinds", kind + ".py"),
                       "bench_kind_" + kind)
