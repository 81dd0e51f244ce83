"""The 95th percentile of the traced window's pull-test host seconds
(under the profiler, so higher than untraced)."""

import statistics


def read(view):
    if view.kind != "pull_test" or len(view.unit_s) < 2:
        return None
    return statistics.quantiles(view.unit_s, n=20, method="inclusive")[18]
