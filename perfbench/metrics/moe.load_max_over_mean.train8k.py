"""Per-layer metric ``moe.load_max_over_mean.train8k`` (ratio): over the
window, the busiest local expert's rows summed over the MoE layers
(program counter ``lm.moe.max_local_rows``) over the mean local expert's
(``lm.moe.local_rows`` / the experts held): 1 is an even load; the
slowest expert paces a layer. Returns None where the run has nothing for
it to read."""


def read(ctx):
    c = ctx["counters"]
    counts = c.get("program", {}).get("counts", {})
    rows, top = counts.get("lm.moe.local_rows"), counts.get("lm.moe.max_local_rows")
    if not rows or not top or not c.get("experts_held"):
        return None
    return top / (rows / c["experts_held"])
