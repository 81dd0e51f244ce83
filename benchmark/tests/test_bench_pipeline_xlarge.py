"""The xlarge pipeline cell on the CPU:

- one run of ``pipeline-xlarge`` at a small growth (``conftest.
  SMALL_GROWTH``: ``copy_benchmark`` cuts every growth configuration)
  through the harness, past its look for a card, reads correct;
- a traced small run of each pipeline cell gives a number for each of the
  four readers of the program's export, build and solve spans and
  counters (``export_s.pipeline``, ``build_plan_s.pipeline``,
  ``k6_solves.pipeline``, ``solve_roofline.pipeline``); the CPU has no
  device timeline and no peak, so for the roofline the card's peak is
  given and the host time inside the solve spans stands for their device
  time;
- ``solve_roofline.pipeline``'s bytes by hand for two networks of
  different sizes, and its readers read nothing without their inputs."""

import types

import pytest

from conftest import ROOT, run_small
from benchmark.harness import cell as hcell
from benchmark.harness.spec import metric_reader
from benchmark.harness.trace import TraceView

CELLS = ("pipeline-demo", "pipeline-xlarge")
NEW = ("export_s.pipeline", "build_plan_s.pipeline", "k6_solves.pipeline",
       "solve_roofline.pipeline")
H100 = {"hbm_bytes_s": 3.35e12}


def test_xlarge_run_is_correct(small_root):
    out = run_small(small_root, "pipeline-xlarge", seconds=1.0)
    res = out.result
    assert res["correct"], res
    assert res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["metrics"]) == {"pipeline_s", "setup_s"}
    assert {"growth_pos_err", "growth_off", "mesh_off",
            "residual"} <= set(res["checked"])


@pytest.mark.parametrize("cell", CELLS)
def test_traced_run_reads_the_new_metrics(small_root, monkeypatch, cell):
    monkeypatch.setattr(hcell, "peaks", lambda kind: H100)
    monkeypatch.setattr(TraceView, "device_s", TraceView.host_s)
    out = run_small(small_root, cell, seconds=1.0, traced=True)
    m = out.result["metrics"]
    assert set(NEW) <= set(m), sorted(m)
    assert m["k6_solves.pipeline"]["value"] == 100.0
    assert m["export_s.pipeline"]["value"] > 0
    assert m["build_plan_s.pipeline"]["value"] > 0
    assert 0 < m["solve_roofline.pipeline"]["value"] < 100


class _Trace:
    def __init__(self, solve_s: float):
        self.solve_s = solve_s

    def device_s(self, name):
        return self.solve_s if name == "solve_displacement" else 0.0


def _view(reg, solve_s=1e-3, kind="pipeline", peaks=H100):
    return types.SimpleNamespace(kind=kind, unit_s=[1.0], float_bytes=4,
                                 trace=_Trace(solve_s), peaks=peaks,
                                 registry=reg)


@pytest.fixture
def registry(monkeypatch):
    """The program's registry as the readers read it, set by each test."""
    from benchmark.metrics import program_readings
    held = {}

    def readings(view, kind):
        return held.get("reg") if view.kind == kind else None
    monkeypatch.setattr(program_readings, "readings", readings)
    return held


def _read(name, view):
    return metric_reader(ROOT, name)(view)


def test_solve_roofline_bytes_by_hand(registry):
    # two solves of a network of 1,000 nodes and 990 elements and three of
    # one of 7,000 nodes and 7,100 elements, float32: a solve reads the
    # coordinates and x0 (2 x 3N floats), the connectivity (2E int32), the
    # active mask (E bytes), the anchored mask and two grip masks (3N
    # bytes), the two grip displacements (2 floats) and writes x (3N
    # floats)
    def by_hand(n, e):
        return 3 * n * 4 + 2 * e * 4 + e + 3 * n + 2 * 4 + 2 * 3 * n * 4

    assert by_hand(1000, 990) == 9 * 4 * 1000 + 3 * 1000 + 9 * 990 + 8
    want = 2 * by_hand(1000, 990) + 3 * by_hand(7000, 7100)
    registry["reg"] = {"fea.solve": {"count": 5, "host_s": 0.1},
                       "fea.solve.nodes": 2 * 1000 + 3 * 7000,
                       "fea.solve.elems": 2 * 990 + 3 * 7100,
                       "fea.route.tree_cg": 5}
    got = _read("solve_roofline.pipeline", _view(None, solve_s=2e-3))
    assert got == pytest.approx(100 * want / 3.35e12 / 2e-3)


def test_new_readers_read_nothing_without_their_inputs(registry):
    full = {"fea.solve": {"count": 4, "host_s": 0.1},
            "growth.export": {"count": 2, "host_s": 0.5},
            "fea.build": {"count": 2, "host_s": 3.0},
            "fea.build.schedule": {"count": 2, "host_s": 0.4},
            "fea.build.chain": {"count": 2, "host_s": 0.6},
            "fea.build.tree": {"count": 2, "host_s": 1.0},
            "fea.build.kernels": {"count": 2, "host_s": 0.8},
            "fea.solve.nodes": 400, "fea.solve.elems": 390,
            "fea.route.tree_cg": 3, "fea.route.hybrid": 1}
    registry["reg"] = full
    got = {n: _read(n, _view(None)) for n in NEW}
    assert got["export_s.pipeline"] == pytest.approx(0.25)
    assert got["build_plan_s.pipeline"] == pytest.approx(1.0)
    assert got["k6_solves.pipeline"] == pytest.approx(75.0)
    assert got["solve_roofline.pipeline"] > 0
    for n in NEW:
        assert _read(n, _view(None, kind="pull_test")) is None
    # a program with no such span or counter (the parent's) reads nothing
    registry["reg"] = {"fea.solve": {"count": 4, "host_s": 0.1}}
    for n in NEW:
        assert _read(n, _view(None)) is None, n
    registry["reg"] = full
    assert _read("solve_roofline.pipeline", _view(None, peaks=None)) is None
    assert _read("solve_roofline.pipeline", _view(None, solve_s=0.0)) is None
