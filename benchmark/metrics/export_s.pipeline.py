"""Host seconds of a pipeline's export: the program's span
``growth.export`` (``growth/export.py::state_mesh``) over its count, in the
traced window (``program_readings.py``)."""

from benchmark.metrics.program_readings import count, host_s, readings


def read(view):
    reg = readings(view, "pipeline")
    n = 0 if reg is None else count(reg, "growth.export")
    return host_s(reg, "growth.export") / n if n else None
