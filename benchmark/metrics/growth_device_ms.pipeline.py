"""Device milliseconds a pipeline's growth launches: the operations
launched inside the ``bench.growth`` spans (K4 and the growth's PyTorch
operations) over their count."""

from benchmark.metrics.stage_spans import per_unit


def read(view):
    s = per_unit(view, "bench.growth", device=True)
    return None if s is None else 1e3 * s
