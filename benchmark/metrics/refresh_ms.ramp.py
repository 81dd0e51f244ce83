"""Device milliseconds a pull test inside the ``refresh_anchored`` spans (the
operations launched there), in the traced window."""


def read(view):
    t = view.trace
    if view.kind != "pull_test" or t is None or not view.unit_s:
        return None
    return 1e3 * t.device_s("refresh_anchored") / len(view.unit_s)
