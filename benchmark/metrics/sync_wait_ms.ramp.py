"""Host milliseconds a pull test inside the program's blocking reads
(``fea.sync.*`` spans: the refresh's flag a trip, the solve's stats, the
step's flag, the status reads), in the traced window
(``program_readings.py``: the registry holds that window only)."""

from benchmark.metrics.program_readings import count, host_s, readings


def read(view):
    reg = readings(view, "pull_test")
    if reg is None or not count(reg, "fea.sync."):
        return None
    return 1e3 * host_s(reg, "fea.sync.") / len(view.unit_s)
