"""Host spans and monotone counters of one object (a trainer owns one).

``span(name)`` times a block on the host clock and counts its calls; while
a torch profiler records, the block is also a ``record_function`` range,
so kineto puts it on the clock of the device's kernels and copies and its
nesting names each span's parent.  Outside a profiler no range is built:
one costs 7-15 us of host time even with the profiler off, a span without
it about 2 us.  ``count(name, n)`` adds to a counter.  ``snapshot()``
gives the totals since construction; read a window as the difference of
two snapshots, as ``chem_stats()`` is read.  Spans may be entered from
several threads (the learner's sampler thread).
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict

import torch
from torch.profiler import record_function


class _Span:
    __slots__ = ("rec", "name", "rf", "t0")

    def __init__(self, rec: "SpanRecorder", name: str):
        self.rec, self.name, self.rf = rec, name, None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self.rf = record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self.t0
        if self.rf is not None:
            self.rf.__exit__(*exc)
        self.rec._add(self.name, dt)
        return False


class SpanRecorder:
    """Seconds and calls per span name, and counts per counter name."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._seconds: dict[str, float] = defaultdict(float)
        self._calls: dict[str, int] = defaultdict(int)
        self._counts: dict[str, int] = defaultdict(int)

    def span(self, name: str) -> _Span:
        """Context manager: one call of span ``name`` and its host seconds."""
        return _Span(self, name)

    def _add(self, name: str, seconds: float) -> None:
        with self._lock:
            self._seconds[name] += seconds
            self._calls[name] += 1

    def count(self, name: str, n: int = 1) -> None:
        """Add ``n`` to counter ``name``."""
        with self._lock:
            self._counts[name] += n

    def snapshot(self) -> dict[str, dict]:
        """``{"seconds", "calls", "counts"}``: plain dicts of the totals
        since construction."""
        with self._lock:
            return {"seconds": dict(self._seconds), "calls": dict(self._calls),
                    "counts": dict(self._counts)}
