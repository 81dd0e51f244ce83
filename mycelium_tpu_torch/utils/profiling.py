"""Tracing and step timers (port of ``mycelium_tpu/utils/profiling.py``).

    with trace("/tmp/trace"):
        run_ramp(...)

    timer = StepTimer()
    with timer.step():
        ...
    timer.write("fea_results/solve_runtime.txt")

``window_ms(fn, reps)`` times back-to-back calls: between two CUDA
events on the card, on the host clock between two synchronisations on
the CPU. ``trace`` is a ``torch.profiler`` window over the block, with CPU activity
and, when a card is present, CUDA activity; it writes one Chrome trace
(``trace.json``, viewable in Perfetto or chrome://tracing) into its
directory. A profiler window slows every later launch of the process on
the host: take host-clock readings before it.

The program's own spans and counters:

    with span("fea.refresh"):
        ...
    count("fea.cg_iters", res.iters)
    readings()   # {"fea.refresh": {"count": 1, "host_s": ...},
                 #  "fea.cg_iters": 7}

are on only while a ``torch.profiler`` records on the calling thread
(``trace`` above, or any other profiler window): a span then enters
``torch.profiler.record_function``, so it lies in the profiler's trace on
the clock of the device operations launched inside it, and adds its host
time and one to its count in the registry; a counter adds to its total.
``host_span`` adds to the registry alone, with no ``record_function``: for
a short read inside a span whose host time a reading takes apart, where
the inner annotation's own cost (~13 us on an H100 host) would fall in
the parent and outside the child. With no profiler a span is one shared
no-op context and a counter does nothing. The registry keeps totals since
the last ``reset_readings()``; the timeline of single spans is the
profiler's.

A CUDA profiler lays every annotation, a span or its own
``ProfilerStep``, on the device timeline too: ``device_ops`` gives a
window's device operations without them.
"""

from __future__ import annotations

import contextlib
import os
import statistics
import time
from typing import Dict, List

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import record_function

from ..io.writers import write_solve_runtimes

TRACE_FILE = "trace.json"

_OFF = contextlib.nullcontext()
_SPANS: Dict[str, List[int]] = {}      # name -> [count, host ns]
_COUNTERS: Dict[str, int] = {}

# whether a profiler records on the calling thread: the spans' one switch
on = _profiler_enabled


class _HostSpan:
    __slots__ = ("name", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        tot = _SPANS.setdefault(self.name, [0, 0])
        tot[0] += 1
        tot[1] += time.perf_counter_ns() - self.t0


@contextlib.contextmanager
def _span(name: str):
    with record_function(name), _HostSpan(name):
        yield


def span(name: str):
    """A span ``name`` over the block while a profiler records, else the
    shared no-op context."""
    return _span(name) if _profiler_enabled() else _OFF


def host_span(name: str):
    """The span ``name`` in the registry alone, with no annotation in the
    profiler's trace, while a profiler records; else the shared no-op
    context."""
    return _HostSpan(name) if _profiler_enabled() else _OFF


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while a profiler records."""
    if _profiler_enabled():
        _COUNTERS[name] = _COUNTERS.get(name, 0) + int(n)


def readings() -> dict:
    """``{span: {"count": int, "host_s": float}}`` and ``{counter: int}``,
    totals since the last ``reset_readings()``."""
    out = {n: {"count": c, "host_s": ns * 1e-9}
           for n, (c, ns) in _SPANS.items()}
    out.update(_COUNTERS)
    return out


def reset_readings() -> None:
    _SPANS.clear()
    _COUNTERS.clear()


def device_ops(prof, device_type=torch.autograd.DeviceType.CUDA) -> list:
    """The operations a finished profiler window put on ``device_type``:
    its events there less the annotations (spans, ``ProfilerStep``) that
    the profiler lays on the same timeline."""
    return [e for e in prof.events()
            if e.device_type == device_type and not e.is_user_annotation]


@contextlib.contextmanager
def trace(log_dir: str):
    """Trace the block into ``log_dir/trace.json``. On a machine with a
    card the trace records CUDA activity or this raises."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield log_dir
        if cuda:
            torch.cuda.synchronize()
    if cuda and not device_ops(prof):
        raise RuntimeError("torch.profiler recorded no CUDA activity: the "
                           "trace would show the host only")
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def window_ms(fn, reps: int, device="cuda", windows: int = 1,
              warm: int = 1):
    """(median milliseconds a call of ``fn``, its last result): ``warm``
    calls, then ``windows`` windows of ``reps`` back-to-back calls, each
    timed between two CUDA events on the card, or on the host clock
    between two synchronisations on the CPU."""
    cuda = torch.device(device).type == "cuda"
    out = None
    for _ in range(warm):
        out = fn()
    if cuda:
        torch.cuda.synchronize(device)
    ms = []
    for _ in range(windows):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        if cuda:
            end.record()
            end.synchronize()
            ms.append(start.elapsed_time(end) / reps)
        else:
            ms.append((time.perf_counter() - t0) * 1e3 / reps)
    return statistics.median(ms), out


class StepTimer:
    """Per-step wall timers for the solve_runtime.txt contract
    (src/fea_solver.py:213-215,247,260-261)."""

    def __init__(self):
        self.seconds: List[float] = []

    @contextlib.contextmanager
    def step(self):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds.append(time.perf_counter() - t0)

    def write(self, path_or_dir: str) -> None:
        d = path_or_dir
        if d.endswith(".txt"):
            d = os.path.dirname(d)
        write_solve_runtimes(d or ".", self.seconds)
