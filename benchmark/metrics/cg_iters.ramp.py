"""Iterations a solve of the pull tests: the program's counter
``fea.cg_iters`` over its ``fea.solve`` spans, in the traced window
(``program_readings.py``: the registry holds that window only)."""

from benchmark.metrics.program_readings import count, readings


def read(view):
    reg = readings(view, "pull_test")
    n = 0 if reg is None else count(reg, "fea.solve")
    return reg.get("fea.cg_iters", 0) / n if n else None
