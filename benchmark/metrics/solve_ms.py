"""Milliseconds a cold solve: the window's host time over the solves it
completed."""


def read(view):
    if view.kind != "cold_solve" or not view.unit_s:
        return None
    return 1e3 * view.window_s / len(view.unit_s)
