"""Fixpoint trips a grip-reachability refresh: the program's
``fea.refresh.trip`` spans over its ``fea.refresh`` spans, in the traced
window (``program_readings.py``: the registry holds that window only)."""

from benchmark.metrics.program_readings import count, readings


def read(view):
    reg = readings(view, "pull_test")
    n = 0 if reg is None else count(reg, "fea.refresh")
    return count(reg, "fea.refresh.trip") / n if n else None
