"""The trace reduction as it stood before driver stage spans
(``bench.<stage>``) were kept: the yardstick that the repaired
``harness/trace.py`` must equal on traces holding only the spans it knew
(``test_bench_trace_stages.py``)."""

from collections import defaultdict

from benchmark.harness.trace import (PROGRAM_SPANS, SPAN_NAMES, UNIT_SPAN,
                                     WINDOW_SPAN, _busy_and_gaps, _Intervals,
                                     _top)


class ParentTraceView:
    """The reduced trace: per span name its count, host time and the
    device time of the operations launched inside it; the device's busy
    time in the window; the device operations and idle gaps by name."""

    def __init__(self, events):
        import torch
        cuda = torch.autograd.DeviceType.CUDA
        spans = defaultdict(list)
        launch_at = {}
        device = []
        for e in events:
            name = e.name()
            if e.device_type() == cuda:
                if e.is_user_annotation() or name in SPAN_NAMES:
                    continue
                device.append((e.start_ns(), e.start_ns() + e.duration_ns(),
                               e.correlation_id(), name))
            elif name in SPAN_NAMES:
                spans[name].append((e.start_ns(),
                                    e.start_ns() + e.duration_ns()))
            elif name.startswith("cu"):      # runtime and driver calls
                launch_at[e.correlation_id()] = e.start_ns()
        self.spans = {n: _Intervals(p) for n, p in spans.items()}
        win = self.spans.get(WINDOW_SPAN)
        if win is None or len(win) != 1:
            raise RuntimeError("the trace holds no window span")
        w0, w1 = win.starts[0], win.ends[0]
        self.window_s = (w1 - w0) * 1e-9
        device = [d for d in device if d[1] > w0 and d[0] < w1]
        self.n_device_ops = len(device)
        self.unlinked = 0
        inside = defaultdict(int)
        by_op = defaultdict(int)
        for a, b, corr, name in device:
            by_op[name] += b - a
            t = launch_at.get(corr)
            if t is None:
                self.unlinked += 1
                continue
            for n in PROGRAM_SPANS:
                iv = self.spans.get(n)
                if iv is not None and iv.find(t) >= 0:
                    inside[n] += b - a
        self.inside_ns = dict(inside)
        busy, gaps = _busy_and_gaps(device, w0, w1)
        self.busy_s = busy * 1e-9
        idle = defaultdict(int)
        for a, b in gaps:
            idle[self._host_state((a + b) // 2)] += b - a
        self.device_ops = _top(by_op)
        self.idle_gaps = _top(idle)

    def _host_state(self, t: int) -> str:
        best, best_len = "outside spans", None
        for n in PROGRAM_SPANS + (UNIT_SPAN,):
            iv = self.spans.get(n)
            i = -1 if iv is None else iv.find(t)
            if i >= 0:
                ln = iv.ends[i] - iv.starts[i]
                if best_len is None or ln < best_len:
                    best, best_len = n, ln
        return best

    def count(self, name: str) -> int:
        iv = self.spans.get(name)
        return 0 if iv is None else len(iv)

    def host_s(self, name: str) -> float:
        iv = self.spans.get(name)
        return 0.0 if iv is None else iv.total() * 1e-9

    def device_s(self, name: str) -> float:
        """Device seconds of the operations launched inside spans
        ``name``."""
        return self.inside_ns.get(name, 0) * 1e-9


