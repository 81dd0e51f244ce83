"""The pipelines' solves' share of their roofline, in %: the least time
their bytes take at the card's HBM bandwidth over the device time of the
operations launched inside the ``solve_displacement`` spans, as
``solve_roofline.ramp``; each solve's bytes (``solve_bytes.py``) are its own
network's, from the program's counters ``fea.solve.nodes`` and
``fea.solve.elems`` (the solved models' nodes and elements, added a solve)
over its ``fea.solve`` spans (``program_readings.py``)."""

from benchmark.metrics.program_readings import count, readings
from benchmark.metrics.solve_bytes import problem_bytes


def window_bytes(n_solves: int, nodes: int, elems: int,
                 float_bytes: int) -> int:
    """The least bytes of ``n_solves`` solves whose networks sum to
    ``nodes`` nodes and ``elems`` elements: ``problem_bytes`` is linear in
    the two, plus the grips' two floats a solve."""
    return problem_bytes(nodes, elems, float_bytes) \
        + (n_solves - 1) * problem_bytes(0, 0, float_bytes)


def read(view):
    reg = readings(view, "pipeline")
    t = view.trace
    n = 0 if reg is None else count(reg, "fea.solve")
    if not n or "fea.solve.nodes" not in reg or view.peaks is None:
        return None
    dev = t.device_s("solve_displacement")
    if dev <= 0:
        return None
    least = window_bytes(n, reg["fea.solve.nodes"], reg["fea.solve.elems"],
                         view.float_bytes) / view.peaks["hbm_bytes_s"]
    return 100.0 * least / dev
