"""The share of the window's solves that took K6, in %: the program's
counter ``fea.route.tree_cg`` over its ``fea.solve`` spans
(``program_readings.py``). A program that counts no route reads as
nothing."""

from benchmark.metrics.program_readings import count, readings


def read(view):
    reg = readings(view, "pipeline")
    n = 0 if reg is None else count(reg, "fea.solve")
    if not n or not any(k.startswith("fea.route.") for k in reg):
        return None
    return 100.0 * reg.get("fea.route.tree_cg", 0) / n
