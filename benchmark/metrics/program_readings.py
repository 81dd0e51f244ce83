"""The program's own spans and counters, as the per-layer readers of them
take them: ``mycelium_tpu_torch.utils.profiling.readings()``, totals a
span name (``count``, ``host_s``) and a counter name. They are on only
under a profiler, and in a run of the benchmark the only block under a
profiler is the traced window, so the registry holds the window and
nothing else. A program without the registry reads as nothing."""


def readings(view, kind: str):
    """The registry of a traced run of ``kind`` that completed a unit, or
    None (another kind, an untraced run, no unit, no registry)."""
    if view.kind != kind or view.trace is None or not view.unit_s:
        return None
    # the traced runs of the program before the registry run these readers
    # too, and read nothing
    from mycelium_tpu_torch.utils import profiling
    read = getattr(profiling, "readings", None)
    return None if read is None else read()


def _spans(reg: dict, name: str):
    """The spans ``name``, or where it ends in a dot (``fea.sync.``) every
    span whose name starts with it."""
    group = name.endswith(".")
    return [v for n, v in reg.items() if isinstance(v, dict)
            and (n.startswith(name) if group else n == name)]


def count(reg: dict, name: str) -> int:
    return sum(v["count"] for v in _spans(reg, name))


def host_s(reg: dict, name: str) -> float:
    return sum(v["host_s"] for v in _spans(reg, name))
