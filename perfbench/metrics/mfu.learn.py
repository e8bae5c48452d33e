"""Per-layer metric ``mfu.learn`` (%): the window's Q-network FLOPs of the
learner's worker updates, counted from shapes
(``harness.work.learner_update_flops``), over the window's seconds at
the f32 peak (TF32 is off). Returns None where the run has nothing for
it to read."""

from perfbench.harness.work import F32_PEAK_FLOPS


def read(ctx):
    c = ctx["counters"]
    if not c.get("rounds"):
        return None
    return 100.0 * c["flops"] / (c["window_s"] * F32_PEAK_FLOPS)
