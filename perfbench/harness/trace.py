"""The benchmark's own host spans, and the reduction of a torch.profiler
trace to the device's busy time, its largest operations and its idle gaps.

Spans are recorded from the benchmark's files only, around its calls into
the program's layers (``Spans.wrap`` replaces one bound method of one
object the benchmark built); their host seconds are always summed, and in
a traced run each span is also a ``record_function`` range, so an idle gap
of the device can be named by the host span it falls in."""

from __future__ import annotations

import time
from collections import defaultdict
from contextlib import contextmanager

TOP = 10


class Spans:
    def __init__(self):
        self.seconds: dict[str, float] = defaultdict(float)
        self.profiling = False

    @contextmanager
    def span(self, name: str):
        rf = None
        if self.profiling:
            from torch.profiler import record_function
            rf = record_function(name)
            rf.__enter__()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.seconds[name] += time.perf_counter() - t0
            if rf is not None:
                rf.__exit__(None, None, None)

    def wrap(self, obj, attr: str, name: str) -> bool:
        """Time every call of ``obj.attr`` under span ``name``; False (and
        nothing wrapped) where the object has no such attribute."""
        fn = getattr(obj, attr, None)
        if fn is None:
            return False

        def timed(*a, **k):
            with self.span(name):
                return fn(*a, **k)
        setattr(obj, attr, timed)
        return True


class ProfileWindow:
    """Turns the kineto profiler (CPU and CUDA activity) on at the first
    ``poll`` once ``offset_s`` seconds of the measured window have passed,
    and off at the first ``poll`` ``length_s`` seconds later or when the
    window ends.  The driver's loop polls between its steps, so a traced
    part holds whole steps."""

    def __init__(self, spans: Spans, offset_s: float, length_s: float):
        self.spans = spans
        self.offset_s = offset_s
        self.length_s = length_s
        self.prof = None
        self.done = False
        self._t0 = None
        self._t_on = None
        self._marker = None
        # a counter of the driver's, read as the profiler turns on and off
        self.probe = None
        self.probe_on = self.probe_off = None

    def start_window(self) -> None:
        self._t0 = time.perf_counter()

    def poll(self) -> None:
        if self.done:
            return
        import torch
        now = time.perf_counter()
        if self.prof is None and now - self._t0 >= self.offset_s:
            from torch.autograd.profiler import profile
            from torch.profiler import record_function
            torch.cuda.synchronize()
            self.prof = profile(use_device="cuda", use_kineto=True)
            self.prof.__enter__()
            self._marker = record_function("perfbench.traced")
            self._marker.__enter__()
            self.spans.profiling = True
            if self.probe is not None:
                self.probe_on = self.probe()
            self._t_on = time.perf_counter()
        elif self.prof is not None and now - self._t_on >= self.length_s:
            self.stop()

    def stop(self) -> None:
        if self.prof is None or self.done:
            return
        import torch
        torch.cuda.synchronize()
        if self.probe is not None:
            self.probe_off = self.probe()
        self.spans.profiling = False
        self._marker.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.done = True


def reduce_trace(prof, span_names) -> dict | None:
    """From the raw kineto events of one traced window: the window's
    length, the seconds in which any device operation ran (the union of
    kernels, copies and sets), device seconds by operation name, and the
    idle gaps of the device, each named by the innermost benchmark span
    that covers its middle.  None where the trace holds no window."""
    events = prof.kineto_results.events()
    window = None
    dev, host = [], []
    names = set(span_names)
    for e in events:
        if "CPU" in str(e.device_type()):
            n = e.name()
            if n == "perfbench.traced":
                window = (e.start_ns(), e.end_ns())
            elif n in names:
                host.append((e.start_ns(), e.end_ns(), n))
        elif e.duration_ns() > 0 and not e.is_user_annotation() \
                and e.name() not in names and e.name() != "perfbench.traced":
            dev.append((e.start_ns(), e.end_ns(), e.name()))
    if window is None:
        return None
    w0, w1 = window
    by_name: dict[str, float] = defaultdict(float)
    clipped = []
    for s, t, n in dev:
        s, t = max(s, w0), min(t, w1)
        if t > s:
            clipped.append((s, t))
            by_name[n] += (t - s) / 1e9
    clipped.sort()
    busy, gaps, cur_s, cur_t = 0, [], None, w0
    last_end = w0
    for s, t in clipped:
        if cur_s is None or s > cur_t:
            if cur_s is not None:
                busy += cur_t - cur_s
            if s > last_end:
                gaps.append((last_end, s))
            cur_s, cur_t = s, t
        else:
            cur_t = max(cur_t, t)
        last_end = max(last_end, t)
    if cur_s is not None:
        busy += cur_t - cur_s
    if w1 > last_end:
        gaps.append((last_end, w1))
    gaps.sort(key=lambda g: g[0] - g[1])
    labelled = []
    for g0, g1 in gaps[:TOP]:
        mid = (g0 + g1) // 2
        inside = [(t - s, n) for s, t, n in host if s <= mid <= t]
        labelled.append([min(inside)[1] if inside else "outside_spans",
                         (g1 - g0) / 1e9])
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])
    return {"window_s": (w1 - w0) / 1e9, "busy_s": busy / 1e9,
            "device_s_by_name": dict(by_name),
            "device_ops": [[n, s] for n, s in ops[:TOP]],
            "idle_gaps": labelled}
