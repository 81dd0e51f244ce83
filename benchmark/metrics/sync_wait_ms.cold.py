"""Host milliseconds a cold solve in its stats read, the one blocking read
of the solve (the program's ``fea.sync.stats`` spans), over the solves of
the traced window (``program_readings.py``: the registry holds that window
only)."""

from benchmark.metrics.program_readings import count, host_s, readings


def read(view):
    reg = readings(view, "cold_solve")
    if reg is None or not count(reg, "fea.sync.stats"):
        return None
    return 1e3 * host_s(reg, "fea.sync.stats") / len(view.unit_s)
