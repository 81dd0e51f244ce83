"""The share of the traced window in which no operation ran on the
card, in %."""


def read(view):
    t = view.trace
    if view.kind != "cold_solve" or t is None:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
