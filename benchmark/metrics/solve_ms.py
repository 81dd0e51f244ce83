"""Milliseconds a cold solve: the window's host time over the solves it
completed, for both cold-solve kinds (``cold_solve``, ``solver_sweep``)."""


def read(view):
    if view.kind not in ("cold_solve", "solver_sweep") or not view.unit_s:
        return None
    return 1e3 * view.window_s / len(view.unit_s)
