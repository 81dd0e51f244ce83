"""The pipeline driver's stage spans (``bench.growth``, ``bench.export``,
``bench.build``, ``bench.ramp``) in a traced run, a pipeline at a time."""


def per_unit(view, name: str, device: bool = False):
    """Host seconds (device seconds of the operations launched there, with
    ``device``) inside the spans ``name`` over their count, or None
    (another kind, untraced, no such span)."""
    t = view.trace
    if view.kind != "pipeline" or t is None or not t.count(name):
        return None
    return (t.device_s(name) if device else t.host_s(name)) / t.count(name)
