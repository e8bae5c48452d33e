"""Per-layer metric ``optim.adam_ms_per_step.train8k`` (ms): device time of
the kernels launched inside the program's ``lm.adam`` span (the clip's
norm, ``optim/adam.py``'s per-leaf update, the new parameters), per traced
step. Returns None where the run has nothing for it to read."""


def read(ctx):
    c = ctx["counters"].get("traced")
    if not c or not c.get("steps"):
        return None
    t = c["span_device_s"].get("lm.adam", 0.0)
    if t <= 0:
        return None
    return 1e3 * t / c["steps"]
