"""Host seconds of ``build_model`` on the grown network inside a pipeline:
the ``bench.build`` spans over their count."""

from benchmark.metrics.stage_spans import per_unit


def read(view):
    return per_unit(view, "bench.build")
