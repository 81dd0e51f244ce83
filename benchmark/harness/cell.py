"""One run of one cell: set-up, the measured window, the comparison with
the reference, the metrics.

Order: the traffic driver builds the networks and the program's models
and runs one unit of each network (set-up, ``setup_s`` from the process's
start to here); units run back to back until ``seconds`` have passed, the
unit in flight finishing the window; the card's memory peak is read; the
program's state is freed; the reference judges the units the driver kept;
each metric's reader reads the run. A traced run (``traced``) puts the
window under ``torch.profiler`` with the spans of ``trace.py`` and reports
the per-layer metrics, an untraced one the end-to-end metrics.
"""

from __future__ import annotations

import contextlib
import time
from typing import NamedTuple

from .peaks import peaks
from .spec import kind_module, load_cell, metric_reader
from .trace import UNIT_SPAN, TraceView, no_span, profiled, program_spans, \
    span

FLOAT_BYTES = {"float32": 4, "float64": 8}


class RunView:
    """What a metric's reader reads: ``kind`` (the mix's driver),
    ``unit_s`` (host seconds of each completed unit), ``window_s``,
    ``setup_s``, ``plan_build_s`` (host seconds of each ``build_model``),
    ``counters`` (the driver's, by name, a value a unit; traced runs),
    ``trace`` (a ``TraceView``, or None untraced), ``n_nodes`` /
    ``n_elems`` / ``float_bytes`` of the networks, ``peaks`` (the card's,
    or None)."""

    def __init__(self, **kw):
        self.__dict__.update(kw)


class Outcome(NamedTuple):
    result: dict          # the JSON line
    checked: list         # (name, value, limit, ok)
    notes: list           # lines for standard error


def run_cell(root: str, workload: str, seed: int, seconds: float,
             traced: bool, device, t0: float) -> Outcome:
    import torch
    cell = load_cell(root, workload)
    kind = kind_module(root, cell.traffic["kind"])
    cuda = device.type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    start_s = time.perf_counter() - t0
    st = kind.setup(cell, seed, device, traced)
    sync()
    setup_s = time.perf_counter() - t0
    unit_span = span if traced else no_span
    unit_s, attempted, failed = [], 0, 0
    with contextlib.ExitStack() as stack:
        events = None
        if traced:
            stack.enter_context(program_spans())
            events = stack.enter_context(profiled())
        w0 = time.perf_counter()
        while True:
            try:
                with unit_span(UNIT_SPAN):
                    unit_s.append(kind.unit(st, attempted))
            except kind.FAILED:
                failed += 1
            attempted += 1
            if time.perf_counter() - w0 >= seconds:
                break
        sync()
        window_s = time.perf_counter() - w0
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    view = TraceView(events) if traced else None
    net = st.nets[0]
    kind.finish(st)
    numbers = kind.check(st)
    checked = [(name, numbers[name], limit, numbers[name] <= limit)
               for name, limit in cell.limits.items()]
    correct = bool(failed == 0 and unit_s and all(c[3] for c in checked))

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    run = RunView(kind=cell.traffic["kind"], unit_s=unit_s,
                  window_s=window_s, setup_s=setup_s,
                  plan_build_s=st.build_s,
                  counters=st.counters if traced else {},
                  trace=view, n_nodes=int(net.coords.shape[0]),
                  n_elems=int(net.conn.shape[0]),
                  float_bytes=FLOAT_BYTES[net.fields["dtype"]],
                  peaks=peaks(dev["kind"]))
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        v = metric_reader(root, m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if traced:
        dev.update(busy_s=view.busy_s, window_s=view.window_s)
        result["breakdown"] = {"device_ops": view.device_ops,
                               "idle_gaps": view.idle_gaps}
    result["checked"] = {n: {"value": v, "limit": lim}
                         for n, v, lim, _ in checked}
    us = sorted(unit_s) or [0.0]
    notes = [f"setup_s {setup_s!r} window_s {window_s!r} units {attempted} "
             f"unit_s min {us[0]!r} median {us[len(us) // 2]!r} "
             f"max {us[-1]!r}",
             f"setup: start {start_s!r} meshes {st.mesh_s!r} "
             f"build_model {st.build_s!r}",
             f"numbers {numbers!r}"]
    if traced:
        notes.append(f"trace: {view.n_device_ops} device operations, "
                     f"{view.unlinked} not tied to a launch")
    for name, vals in (st.counters if traced else {}).items():
        if vals:     # what the traffic did, beside the metrics
            notes.append(f"{name} a unit: mean {sum(vals) / len(vals)!r} "
                         f"min {min(vals)!r} max {max(vals)!r}")
    return Outcome(result, checked, notes)
