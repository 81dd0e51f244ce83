"""Host milliseconds a cold solve outside its stats read: the program's
``fea.solve`` spans' host time less that of the ``fea.sync.stats`` spans
inside them (the free mask, the kernel's set-up and launch), over the
solves of the traced window (``program_readings.py``: the registry holds
that window only)."""

from benchmark.metrics.program_readings import count, host_s, readings


def read(view):
    reg = readings(view, "cold_solve")
    if reg is None or not count(reg, "fea.solve"):
        return None
    return 1e3 * (host_s(reg, "fea.solve") - host_s(reg, "fea.sync.stats")) \
        / len(view.unit_s)
