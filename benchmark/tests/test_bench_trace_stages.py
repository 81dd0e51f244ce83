"""The trace reduction with driver stage spans (``bench.<stage>``):

- on traces that hold only the spans the benchmark had before (the
  program's wrapped layers, the unit, the window), every reading equals the
  former reduction's (``parent_trace.py``), so no existing cell moves;
- a stage span gets the device time launched inside it and names the idle
  gaps the host spent in it, nested program spans stay innermost, and every
  device operation's time is kept by name beside the top ten;
- each reader of the pipeline cell on a stub run: its number, and None for
  another kind, an untraced run, or nothing to read."""

import random
import types

import pytest

from conftest import ROOT
from parent_trace import ParentTraceView
from test_bench_trace import CPU, CUDA, Ev
from benchmark.harness.spec import metric_reader
from benchmark.harness.trace import (PROGRAM_SPANS, SPAN_NAMES, UNIT_SPAN,
                                     WINDOW_SPAN, TraceView, stage_span)


def _old_trace(seed: int, units: int = 12):
    """A window of units, each with wrapped program spans inside, device
    operations launched from any of them (some not tied to a launch, some
    cut by the window's end) and gaps between."""
    rnd = random.Random(seed)
    ev, t, corr = [], 0, 1
    for _ in range(units):
        u0 = t
        t += rnd.randint(1, 50)
        for _ in range(rnd.randint(0, 4)):
            name = rnd.choice(PROGRAM_SPANS)
            s0, dur = t, rnd.randint(20, 400)
            ev.append(Ev(name, CPU, s0, dur, ann=True))
            for _ in range(rnd.randint(0, 3)):
                at = rnd.randint(s0, s0 + dur)
                ev.append(Ev("cudaLaunchKernel", CPU, at, 3, corr=corr))
                ev.append(Ev(f"k{rnd.randint(0, 14)}", CUDA,
                             at + rnd.randint(1, 300), rnd.randint(1, 200),
                             corr=corr))
                corr += 1
            ev.append(Ev(name, CUDA, s0, dur, ann=True))
            t = s0 + dur + rnd.randint(0, 30)
        at = rnd.randint(u0, t)
        ev.append(Ev("cudaMemcpyAsync", CPU, at, 2, corr=corr))
        ev.append(Ev("Memcpy DtoH", CUDA, at + 5, rnd.randint(1, 90),
                     corr=corr))
        corr += 1
        ev.append(Ev("lost", CUDA, rnd.randint(u0, t), 7, corr=10 ** 6))
        ev.append(Ev(UNIT_SPAN, CPU, u0, t - u0, ann=True))
        t += rnd.randint(0, 20)
    ev.append(Ev(WINDOW_SPAN, CPU, 0, t - 10, ann=True))
    rnd.shuffle(ev)
    return ev


@pytest.mark.parametrize("seed", range(6))
def test_readings_equal_the_former_reduction(seed):
    ev = _old_trace(seed)
    new, old = TraceView(ev), ParentTraceView(ev)
    for attr in ("window_s", "busy_s", "n_device_ops", "unlinked",
                 "inside_ns", "device_ops", "idle_gaps"):
        assert getattr(new, attr) == getattr(old, attr), attr
    for name in SPAN_NAMES:
        assert new.count(name) == old.count(name)
        assert new.host_s(name) == old.host_s(name)
        assert new.device_s(name) == old.device_s(name)
    assert not any(stage_span(n) for n in SPAN_NAMES)


def test_stage_spans_take_device_time_and_idle_gaps():
    ev = [
        Ev(WINDOW_SPAN, CPU, 0, 1000, ann=True),
        Ev(UNIT_SPAN, CPU, 0, 1000, ann=True),
        Ev("bench.growth", CPU, 0, 500, ann=True),
        Ev("bench.ramp", CPU, 600, 400, ann=True),
        Ev("solve_displacement", CPU, 700, 100, ann=True),
        Ev("cudaLaunchKernel", CPU, 50, 5, corr=1),
        Ev("cudaLaunchKernel", CPU, 710, 5, corr=2),
        Ev("anast_scan_kernel<4, true, false>", CUDA, 100, 100, corr=1),
        Ev("k6", CUDA, 720, 30, corr=2),
        Ev("bench.growth", CUDA, 0, 500, ann=True),
    ]
    t = TraceView(ev)
    assert t.count("bench.growth") == 1 and t.count("bench.ramp") == 1
    assert t.host_s("bench.growth") == pytest.approx(500e-9)
    assert t.device_s("bench.growth") == pytest.approx(100e-9)
    assert t.device_s("bench.ramp") == pytest.approx(30e-9)
    assert t.device_s("solve_displacement") == pytest.approx(30e-9)
    assert t.device_op_s == pytest.approx(
        {"anast_scan_kernel<4, true, false>": 100e-9, "k6": 30e-9})
    # [0, 100) and [200, 720): mid 50, 460 in growth; [750, 1000): mid
    # 875 in the ramp
    assert dict(t.idle_gaps) == pytest.approx(
        {"bench.growth": 620e-9, "bench.ramp": 250e-9})


class _Trace:
    """A reduced trace by hand: two units' stage spans."""
    spans = {"bench.growth": (2, 2.6, 0.05), "bench.build": (2, 0.4, 0.01),
             "bench.ramp": (2, 0.3, 0.08)}
    busy_s, window_s = 0.75, 3.0
    device_op_s = {"anast_scan_kernel<4, true, false>": 0.002,
                   "k6": 0.05}

    def count(self, n):
        return self.spans.get(n, (0, 0, 0))[0]

    def host_s(self, n):
        return self.spans.get(n, (0, 0, 0))[1]

    def device_s(self, n):
        return self.spans.get(n, (0, 0, 0))[2]


def _view(kind="pipeline", traced=True, counters=None, peaks=True):
    return types.SimpleNamespace(
        kind=kind, unit_s=[1.5, 1.5], window_s=3.0,
        trace=_Trace() if traced else None,
        counters={"growth_syncs": [2.0, 2.02], "anast_bytes": [1e6, 3e6]}
        if counters is None else counters,
        peaks={"hbm_bytes_s": 4e12} if peaks else None)


EXPECTED = {"pipeline_s": 1.5, "growth_s.pipeline": 1.3,
            "growth_device_ms.pipeline": 25.0,
            "growth_syncs.pipeline": 2.01,
            "anast_roofline.pipeline": 100 * 4e6 / 4e12 / 0.002,
            "build_s.pipeline": 0.2, "ramp_s.pipeline": 0.15,
            "device_idle.pipeline": 75.0}


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_pipeline_readers(name):
    read = metric_reader(ROOT, name)
    assert read(_view()) == pytest.approx(EXPECTED[name])
    assert read(_view(kind="pull_test")) is None
    if name != "pipeline_s":
        assert read(_view(traced=False, counters={})) is None


def test_roofline_reads_nothing_without_its_inputs():
    read = metric_reader(ROOT, "anast_roofline.pipeline")
    assert read(_view(peaks=False)) is None
    assert read(_view(counters={"anast_bytes": []})) is None
    view = _view()
    view.trace.device_op_s = {"k6": 0.05}
    assert read(view) is None
