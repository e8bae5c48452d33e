"""Per-layer metric ``learner.sample_ms.learn`` (ms): host milliseconds per
round in the trainer's replay sampling (the benchmark's span around
``_stacked_sample_packed_np``). Returns None where the run has nothing
for it to read."""


def read(ctx):
    c = ctx["counters"]
    s = c.get("span_s", {}).get("learner.sample")
    if s is None or not c.get("rounds"):
        return None
    return 1e3 * s / c["rounds"]
