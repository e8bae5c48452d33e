"""Per-layer metric ``lm.tokens_per_s.train8k`` (tokens/s): the window's
trained tokens over its seconds (host clock; the loop reads each step's
loss, so a step's device work ends inside it). Returns None where the run
has nothing for it to read."""


def read(ctx):
    c = ctx["counters"]
    if not c.get("steps") or not c.get("tokens"):
        return None
    return c["tokens"] / c["window_s"]
