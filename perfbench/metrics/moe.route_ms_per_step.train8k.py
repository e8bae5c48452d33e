"""Per-layer metric ``moe.route_ms_per_step.train8k`` (ms): device time of
the kernels launched inside the program's ``lm.moe.route`` (scores, top-k,
the sort and gather of the local pairs) and ``lm.moe.combine`` (weights
and the scatter-add back) spans, forward and recomputed calls, per traced
step. Returns None where the run has nothing for it to read."""


def read(ctx):
    c = ctx["counters"].get("traced")
    if not c or not c.get("steps"):
        return None
    s = c["span_device_s"]
    t = s.get("lm.moe.route", 0.0) + s.get("lm.moe.combine", 0.0)
    if t <= 0:
        return None
    return 1e3 * t / c["steps"]
