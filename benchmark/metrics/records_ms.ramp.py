"""Host milliseconds a pull test in the program's record writes and
fetches (``fea.records.*`` spans), in the traced window
(``program_readings.py``: the registry holds that window only)."""

from benchmark.metrics.program_readings import count, host_s, readings


def read(view):
    reg = readings(view, "pull_test")
    if reg is None or not count(reg, "fea.records."):
        return None
    return 1e3 * host_s(reg, "fea.records.") / len(view.unit_s)
