"""Per-layer metric ``mfu.train`` (%): the window's Q-network FLOPs (the
fleet dispatches' real candidate rows and the learner's worker updates,
counted from shapes) over the window's seconds at the f32 peak. Returns
None where the run has nothing for it to read."""


from perfbench.harness.work import F32_PEAK_FLOPS


def read(ctx):
    c = ctx["counters"]
    if not c.get("flops"):
        return None
    return 100.0 * c["flops"] / (c["window_s"] * F32_PEAK_FLOPS)
