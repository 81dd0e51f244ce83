"""Host seconds a pipeline of ``build_model``'s host plan: the program's
spans ``fea.build.schedule``, ``fea.build.chain`` and ``fea.build.tree``
summed, over the ``fea.build`` spans, in the traced window
(``program_readings.py``)."""

from benchmark.metrics.program_readings import count, host_s, readings

PLAN = ("fea.build.schedule", "fea.build.chain", "fea.build.tree")


def read(view):
    reg = readings(view, "pipeline")
    n = 0 if reg is None else count(reg, "fea.build")
    if not n or not all(count(reg, p) for p in PLAN):
        return None
    return sum(host_s(reg, p) for p in PLAN) / n
