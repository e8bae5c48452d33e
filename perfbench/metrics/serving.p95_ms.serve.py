"""Per-layer metric ``serving.p95_ms.serve`` (ms): the 95th percentile of
the wall latency (submit to terminal status) of every request that
finished in the window. Returns None where the run has nothing for it to
read."""


def read(ctx):
    v = ctx["counters"].get("p95_latency_s")
    return None if v is None else 1e3 * v
