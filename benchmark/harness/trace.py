"""The traced window: spans from the benchmark's own files and a
``torch.profiler`` trace, reduced to what the per-layer readers take.

Spans: around the program's layers the benchmark wraps, by attribute on
``mycelium_tpu_torch.fea.ramp``, ``refresh_anchored``, ``post_solve`` and
``solve_displacement`` (which ``ramp_step`` and the ramp loops look up
there at every call) with ``torch.profiler.record_function``; a cold solve
and each timed unit get a span from the driver and the harness. A driver
may open spans of its own, each named ``bench.<stage>`` (``stage_span``):
they are kept beside the wrapped layers. The program's own spans are read
from its registry (``metrics/program_readings.py``), not from here.

A device operation belongs to the span in which its launch was made: the
profiler ties each kernel, copy or fill to the runtime call that launched
it (the same correlation id), and that call's host time falls inside the
span's host interval. ``busy_s`` is the union of the device operations'
intervals inside the window; an idle gap is named by the innermost span
the host was in at the gap's middle. ``device_op_s`` keeps every device
operation's seconds by name, ``device_ops`` the largest ten.
"""

from __future__ import annotations

import bisect
import contextlib
from collections import defaultdict

PROGRAM_SPANS = ("refresh_anchored", "post_solve", "solve_displacement")
UNIT_SPAN = "bench.unit"
WINDOW_SPAN = "bench.window"
SPAN_NAMES = PROGRAM_SPANS + (UNIT_SPAN, WINDOW_SPAN)
TOP = 10


def stage_span(name: str) -> bool:
    """A driver's own span: ``bench.<stage>``, not the unit or window."""
    return name.startswith("bench.") and name not in (UNIT_SPAN, WINDOW_SPAN)


def _kept(name: str) -> bool:
    return name in SPAN_NAMES or stage_span(name)


def no_span(name: str):
    return contextlib.nullcontext()


def span(name: str):
    from torch.profiler import record_function
    return record_function(name)


def _wrapped(name: str, fn):
    def call(*args, **kwargs):
        with span(name):
            return fn(*args, **kwargs)
    return call


@contextlib.contextmanager
def program_spans():
    """The program's layer functions wrapped in spans for the block."""
    from mycelium_tpu_torch.fea import ramp
    saved = {n: getattr(ramp, n) for n in PROGRAM_SPANS}
    for n, fn in saved.items():
        setattr(ramp, n, _wrapped(n, fn))
    try:
        yield
    finally:
        for n, fn in saved.items():
            setattr(ramp, n, fn)


@contextlib.contextmanager
def profiled():
    """A ``torch.profiler`` window over the block; yields a list that
    holds the profiler's raw events once the block has ended."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    out = []
    with profile(activities=acts) as prof:
        with span(WINDOW_SPAN):
            yield out
        if cuda:
            torch.cuda.synchronize()
    out.extend(prof.profiler.kineto_results.events())


class _Intervals:
    """Disjoint host intervals of one span name, sorted."""

    def __init__(self, pairs):
        pairs.sort()
        self.starts = [a for a, _ in pairs]
        self.ends = [b for _, b in pairs]

    def find(self, t: int) -> int:
        i = bisect.bisect_right(self.starts, t) - 1
        return i if i >= 0 and t <= self.ends[i] else -1

    def total(self) -> int:
        return sum(b - a for a, b in zip(self.starts, self.ends))

    def __len__(self):
        return len(self.starts)


class TraceView:
    """The reduced trace: per span name its count, host time and the
    device time of the operations launched inside it; the device's busy
    time in the window; the device operations and idle gaps by name."""

    def __init__(self, events):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        spans = defaultdict(list)
        launch_at = {}
        device = []
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                if e.is_user_annotation() or _kept(name):
                    continue
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.correlation_id(), name))
            elif _kept(name):
                spans[name].append((e.start_ns(),
                                    e.start_ns() + e.duration_ns()))
            elif name.startswith("cu"):      # runtime and driver calls
                launch_at[e.correlation_id()] = e.start_ns()
        self.spans = {n: _Intervals(p) for n, p in spans.items()}
        # the spans device time is tied to and idle gaps are named by
        self.layers = PROGRAM_SPANS + tuple(sorted(
            n for n in self.spans if stage_span(n)))
        win = self.spans.get(WINDOW_SPAN)
        if win is None or len(win) != 1:
            raise RuntimeError("the trace holds no window span")
        w0, w1 = win.starts[0], win.ends[0]
        self.window_s = (w1 - w0) * 1e-9
        device = [d for d in device if d[1] > w0 and d[0] < w1]
        self.n_device_ops = len(device)
        self.unlinked = 0
        inside = defaultdict(int)
        by_op = defaultdict(int)
        for a, b, corr, name in device:
            by_op[name] += b - a
            t = launch_at.get(corr)
            if t is None:
                self.unlinked += 1
                continue
            for n in self.layers:
                iv = self.spans.get(n)
                if iv is not None and iv.find(t) >= 0:
                    inside[n] += b - a
        self.inside_ns = dict(inside)
        busy, gaps = _busy_and_gaps(device, w0, w1)
        self.busy_s = busy * 1e-9
        idle = defaultdict(int)
        for a, b in gaps:
            idle[self._host_state((a + b) // 2)] += b - a
        self.device_op_s = {n: ns * 1e-9 for n, ns in by_op.items()}
        self.device_ops = _top(by_op)
        self.idle_gaps = _top(idle)

    def _host_state(self, t: int) -> str:
        best, best_len = "outside spans", None
        for n in self.layers + (UNIT_SPAN,):
            iv = self.spans.get(n)
            i = -1 if iv is None else iv.find(t)
            if i >= 0:
                ln = iv.ends[i] - iv.starts[i]
                if best_len is None or ln < best_len:
                    best, best_len = n, ln
        return best

    def count(self, name: str) -> int:
        iv = self.spans.get(name)
        return 0 if iv is None else len(iv)

    def host_s(self, name: str) -> float:
        iv = self.spans.get(name)
        return 0.0 if iv is None else iv.total() * 1e-9

    def device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside spans
        ``name``."""
        return self.inside_ns.get(name, 0) * 1e-9


def _busy_and_gaps(device, w0: int, w1: int):
    busy = 0
    gaps = []
    cur = w0
    for a, b, _, _ in sorted(device):
        a, b = max(a, w0), min(b, w1)
        if a > cur:
            gaps.append((cur, a))
        if b > cur:
            busy += b - max(a, cur)
            cur = b
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def _top(ns_by_name: dict) -> list:
    items = sorted(ns_by_name.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, ns * 1e-9] for name, ns in items]
