"""Host seconds a pipeline's growth takes: the ``bench.growth`` spans
(``run_growth``, 150 steps with their syncs) over their count."""

from benchmark.metrics.stage_spans import per_unit


def read(view):
    return per_unit(view, "bench.growth")
