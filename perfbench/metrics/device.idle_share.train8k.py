"""Per-layer metric ``device.idle_share.train8k`` (%): the share of the
traced part of the window in which no kernel, copy or set ran on the
device. Returns None where the run has nothing for it to read."""


def read(ctx):
    tr = ctx["trace"]
    if not tr or tr["window_s"] <= 0 or not ctx["counters"].get("tokens"):
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])
