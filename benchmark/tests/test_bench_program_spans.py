"""The per-layer metrics that read the program's own spans and counters
(``mycelium_tpu_torch.utils.profiling.readings()``):

- each reader on a registry filled by hand and a stub run: its number, and
  None for the other kind of traffic, for an untraced run and for a
  program without the registry;
- no program span bears a name of the benchmark's own spans
  (``trace.SPAN_NAMES``), which would nest in them;
- a traced run of each cell on the CPU at 1,500 nodes reports every one of
  the cell's metrics, with a trip or more a refresh and two host reads or
  more a step."""

import json
import os
import types

import pytest

from conftest import ROOT, run_small
from benchmark.harness.spec import metric_reader
from benchmark.harness.trace import SPAN_NAMES

SPEC = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
NEW = ("refresh_trips.ramp", "refresh_host_ms.ramp", "syncs.ramp",
       "sync_wait_ms.ramp", "records_ms.ramp", "cg_iters.ramp",
       "launch_ms.cold", "sync_wait_ms.cold")
PROGRAM_SPANS = ("fea.ramp", "fea.refresh", "fea.refresh.trip",
                 "fea.sync.trip", "fea.post_solve", "fea.solve",
                 "fea.sync.stats", "fea.sync.flag", "fea.sync.status",
                 "fea.records.write", "fea.records.fetch")

# two pull tests, or two cold solves
REG = {"fea.ramp": {"count": 2, "host_s": 3.0},
       "fea.refresh": {"count": 4, "host_s": 0.2},
       "fea.refresh.trip": {"count": 12, "host_s": 0.18},
       "fea.sync.trip": {"count": 12, "host_s": 0.06},
       "fea.solve": {"count": 80, "host_s": 0.5},
       "fea.sync.stats": {"count": 80, "host_s": 0.3},
       "fea.sync.flag": {"count": 80, "host_s": 0.04},
       "fea.sync.status": {"count": 10, "host_s": 0.02},
       "fea.records.write": {"count": 80, "host_s": 0.016},
       "fea.records.fetch": {"count": 2, "host_s": 0.05},
       "fea.post_solve": {"count": 80, "host_s": 0.1},
       "fea.cg_iters": 160}
EXPECTED = {"refresh_trips.ramp": 3.0,
            "refresh_host_ms.ramp": 50.0,
            "syncs.ramp": (12 + 80 + 80 + 10) / 2,
            "sync_wait_ms.ramp": 1e3 * (0.06 + 0.3 + 0.04 + 0.02) / 2,
            "records_ms.ramp": 1e3 * (0.016 + 0.05) / 2,
            "cg_iters.ramp": 2.0,
            "launch_ms.cold": 1e3 * (0.5 - 0.3) / 2,
            "sync_wait_ms.cold": 1e3 * 0.3 / 2}


def _view(kind, traced=True):
    return types.SimpleNamespace(kind=kind, unit_s=[1.0, 1.0],
                                 trace=object() if traced else None)


def _kind(name):
    return "cold_solve" if name.endswith(".cold") else "pull_test"


@pytest.fixture
def registry(monkeypatch):
    from mycelium_tpu_torch.utils import profiling
    monkeypatch.setattr(profiling, "readings", lambda: dict(REG))


@pytest.mark.parametrize("name", NEW)
def test_reader_on_a_hand_filled_registry(registry, name):
    read = metric_reader(ROOT, name)
    kind = _kind(name)
    other = "pull_test" if kind == "cold_solve" else "cold_solve"
    assert read(_view(kind)) == pytest.approx(EXPECTED[name])
    assert read(_view(other)) is None
    assert read(_view(kind, traced=False)) is None


@pytest.mark.parametrize("name", NEW)
def test_reader_without_the_registry(monkeypatch, name):
    """A program without ``readings`` (before the registry) reads as
    nothing, and so does an empty registry."""
    from mycelium_tpu_torch.utils import profiling
    read = metric_reader(ROOT, name)
    monkeypatch.setattr(profiling, "readings", lambda: {})
    assert read(_view(_kind(name))) is None
    monkeypatch.delattr(profiling, "readings")
    assert read(_view(_kind(name))) is None


def test_entries_of_the_new_metrics():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name in NEW:
        m = entries[name]
        assert m["better"] == "lower"
        assert m["moves"] == ("solve_ms" if name.endswith(".cold")
                              else "pulltest_s")
    names = [m["name"] for m in SPEC["per_layer"]]
    first = names.index(NEW[0])
    assert names[first:first + len(NEW)] == list(NEW)


def test_program_spans_apart_from_the_benchmarks():
    assert not set(PROGRAM_SPANS) & set(SPAN_NAMES)
    assert all(n.startswith("fea.") for n in PROGRAM_SPANS)


@pytest.mark.parametrize("cell", [
    w["name"] for w in SPEC["workloads"]
    if any(m["name"] in NEW and w["name"] in m["workloads"]
           for m in SPEC["per_layer"])])
def test_traced_cell_reports_the_new_metrics(small_root, cell):
    from mycelium_tpu_torch.utils import profiling
    profiling.reset_readings()
    out = run_small(small_root, cell, traced=True).result
    reg = profiling.readings()
    profiling.reset_readings()
    assert out["correct"], out
    assert set(n for n in reg if isinstance(reg[n], dict)) \
        <= set(PROGRAM_SPANS)
    wanted = {m["name"] for m in SPEC["per_layer"]
              if m["name"] in NEW and cell in m["workloads"]}
    assert wanted and wanted <= set(out["metrics"]), out["metrics"]
    got = {n: out["metrics"][n]["value"] for n in wanted}
    if "refresh_trips.ramp" in got:
        steps = reg["fea.solve"]["count"] / out["attempted"]
        assert got["refresh_trips.ramp"] >= 1
        assert got["syncs.ramp"] >= 2 * steps
        assert got["cg_iters.ramp"] >= 0
    else:
        assert got["launch_ms.cold"] > 0 and got["sync_wait_ms.cold"] > 0
