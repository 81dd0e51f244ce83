"""The reduction of a trace, on events made by hand: device time goes to
the span in which its launch was made, busy time is the union of the
operations inside the window, idle gaps take the innermost span the host
was in."""

import pytest
import torch

from benchmark.harness.trace import TraceView

CPU, CUDA = torch.autograd.DeviceType.CPU, torch.autograd.DeviceType.CUDA


class Ev:
    def __init__(self, name, dev, start, dur, corr=0, ann=False):
        self._v = (name, dev, start, dur, corr, ann)

    def name(self):
        return self._v[0]

    def device_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def correlation_id(self):
        return self._v[4]

    def is_user_annotation(self):
        return self._v[5]


def test_trace_view():
    ev = [
        Ev("bench.window", CPU, 0, 1000, ann=True),
        Ev("bench.unit", CPU, 0, 900, ann=True),
        Ev("solve_displacement", CPU, 100, 300, ann=True),
        Ev("post_solve", CPU, 500, 100, ann=True),
        Ev("cudaLaunchKernel", CPU, 150, 5, corr=7),
        Ev("cudaLaunchKernel", CPU, 520, 5, corr=8),
        Ev("cudaLaunchKernel", CPU, 950, 5, corr=9),
        Ev("k6", CUDA, 200, 100, corr=7),
        Ev("solve_displacement", CUDA, 200, 100, ann=True),
        Ev("elementwise", CUDA, 250, 150, corr=8),     # overlaps k6
        Ev("late", CUDA, 960, 100, corr=9),            # cut at the window
        Ev("lost", CUDA, 700, 10, corr=99),
    ]
    t = TraceView(ev)
    assert t.window_s == pytest.approx(1000e-9)
    assert t.device_s("solve_displacement") == pytest.approx(100e-9)
    assert t.device_s("post_solve") == pytest.approx(150e-9)
    assert t.count("solve_displacement") == 1
    assert t.host_s("bench.unit") == pytest.approx(900e-9)
    # busy: [200, 400) + [700, 710) + [960, 1000)
    assert abs(t.busy_s - 250e-9) < 1e-15
    assert t.unlinked == 1
    gaps = dict(t.idle_gaps)
    # [0, 200): mid 100 in solve_displacement; [400, 700): mid 550 in
    # post_solve; [710, 960): mid 835 in the unit only
    assert gaps == pytest.approx({"solve_displacement": 200e-9,
                                  "post_solve": 300e-9,
                                  "bench.unit": 250e-9})
    assert dict(t.device_ops)["elementwise"] == pytest.approx(150e-9)
