"""Host seconds of a pipeline's pull test: the ``bench.ramp`` spans
(``run_ramp_async``, records fetched) over their count."""

from benchmark.metrics.stage_spans import per_unit


def read(view):
    return per_unit(view, "bench.ramp")
