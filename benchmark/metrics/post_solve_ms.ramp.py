"""Device milliseconds a pull test inside the ``post_solve`` spans (the
operations launched there), in the traced window."""


def read(view):
    t = view.trace
    if view.kind != "pull_test" or t is None or not view.unit_s:
        return None
    return 1e3 * t.device_s("post_solve") / len(view.unit_s)
