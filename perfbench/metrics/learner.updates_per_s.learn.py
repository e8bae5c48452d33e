"""Per-layer metric ``learner.updates_per_s.learn`` (updates/s): worker
updates (one Adam step on a batch of 32) completed over the window's host
seconds, every round and all of the window's time.  Returns None where
the run has nothing for it to read."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("rounds"):
        return None
    return c["rounds"] * c["workers"] / c["window_s"]
