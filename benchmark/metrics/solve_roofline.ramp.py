"""The solves' share of their roofline, in %: the least time their bytes
take at the card's HBM bandwidth (``solve_bytes.py``) over the device
time of the operations launched inside the ``solve_displacement`` spans."""

from benchmark.metrics.solve_bytes import roofline_pct


def read(view):
    return roofline_pct(view, "pull_test")
