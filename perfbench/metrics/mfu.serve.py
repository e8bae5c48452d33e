"""Per-layer metric ``mfu.serve`` (%): the window's Q-network FLOPs over
the real candidate rows served (padded rows are not work), over the
window's seconds at the f32 peak. Returns None where the run has nothing
for it to read."""

from perfbench.harness.work import F32_PEAK_FLOPS, qnet_row_flops


def read(ctx):
    c = ctx["counters"]
    if not c.get("q_rows"):
        return None
    flops = c["q_rows"] * qnet_row_flops(c["qnet_sizes"])
    return 100.0 * flops / (c["window_s"] * F32_PEAK_FLOPS)
