"""Per-layer metric ``learner.round_ms.learn`` (ms): host milliseconds per
learner round (one ``run_updates`` step of every worker) over the
window. Returns None where the run has nothing for it to read."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("rounds"):
        return None
    return 1e3 * c["window_s"] / c["rounds"]
