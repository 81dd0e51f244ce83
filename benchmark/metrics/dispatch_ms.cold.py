"""Host milliseconds a cold solve that the card does not account for: the
``solve_displacement`` span's host time less the device time of the
operations launched inside it, over the solves."""


def read(view):
    t = view.trace
    if view.kind != "cold_solve" or t is None:
        return None
    n = t.count("solve_displacement")
    if not n:
        return None
    return 1e3 * (t.host_s("solve_displacement")
                  - t.device_s("solve_displacement")) / n
