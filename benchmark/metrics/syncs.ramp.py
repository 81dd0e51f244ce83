"""Blocking host reads a pull test: the program's ``fea.sync.*`` spans
(the refresh's flag a trip, the solve's stats, the step's flag, the status
reads) over the pull tests of the traced window (``program_readings.py``:
the registry holds that window only)."""

from benchmark.metrics.program_readings import count, readings


def read(view):
    reg = readings(view, "pull_test")
    n = 0 if reg is None else count(reg, "fea.sync.")
    return n / len(view.unit_s) if n else None
