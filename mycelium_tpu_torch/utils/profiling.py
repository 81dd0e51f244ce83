"""Tracing and step timers (port of ``mycelium_tpu/utils/profiling.py``).

    with trace("/tmp/trace"):
        run_ramp(...)

    timer = StepTimer()
    with timer.step():
        ...
    timer.write("fea_results/solve_runtime.txt")

``trace`` is a ``torch.profiler`` window over the block, with CPU activity
and, when a card is present, CUDA activity; it writes one Chrome trace
(``trace.json``, viewable in Perfetto or chrome://tracing) into its
directory. A profiler window slows every later launch of the process on
the host: take host-clock readings before it.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import List

import torch

from ..io.writers import write_solve_runtimes

TRACE_FILE = "trace.json"


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
    if cuda and not any(e.device_type == torch.autograd.DeviceType.CUDA
                        for e in prof.events()):
        raise RuntimeError("torch.profiler recorded no CUDA activity: the "
                           "trace would show the host only")
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


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
