"""Device seconds of the kernels launched inside named host ranges of a
kineto trace (the program's spans, ``record_function`` ranges on the
profiler's clock).  A kernel belongs to a range when the host event that
launched it (matched by correlation id) starts inside one of the range's
intervals; the backward's own kernels run outside the forward's ranges,
so a forward range counts its forward and recomputed calls."""

from __future__ import annotations

import bisect


def span_device_seconds(prof, names) -> dict[str, float]:
    events = prof.kineto_results.events()
    intervals: dict[str, list[tuple[int, int]]] = {n: [] for n in names}
    launched_at: dict[int, int] = {}
    kernels = []
    for e in events:
        if "CPU" in str(e.device_type()):
            if e.name() in intervals:
                intervals[e.name()].append((e.start_ns(), e.end_ns()))
            elif e.correlation_id():
                launched_at.setdefault(e.correlation_id(), e.start_ns())
        elif e.duration_ns() > 0 and not e.is_user_annotation():
            kernels.append((e.linked_correlation_id() or e.correlation_id(),
                            e.duration_ns()))
    out = {}
    for n, iv in intervals.items():
        iv.sort()
        starts = [s for s, _ in iv]
        total = 0
        for corr, dur in kernels:
            t = launched_at.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t <= iv[i][1]:
                total += dur
        out[n] = total / 1e9
    return out
