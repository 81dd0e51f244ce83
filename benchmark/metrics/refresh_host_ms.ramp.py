"""Host milliseconds a grip-reachability refresh: the program's
``fea.refresh`` spans' host time over their count, in the traced window
(``program_readings.py``: the registry holds that window only). Set it
against the device time of ``refresh_ms.ramp``."""

from benchmark.metrics.program_readings import count, host_s, readings


def read(view):
    reg = readings(view, "pull_test")
    n = 0 if reg is None else count(reg, "fea.refresh")
    return 1e3 * host_s(reg, "fea.refresh") / n if n else None
