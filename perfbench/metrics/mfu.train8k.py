"""Per-layer metric ``mfu.train8k`` (%): the window's model FLOPs counted
from shapes (``harness.lm_work.step_model_flops``: 6 x the weights each
token passes through, 3 x the routed pairs' forward, 3 x every layer's
causal attention core; recomputation not counted) over the window's
seconds at the bf16 dense peak. Returns None where the run has nothing
for it to read."""

from perfbench.harness.lm_work import BF16_PEAK_FLOPS


def read(ctx):
    c = ctx["counters"]
    if not c.get("steps") or not c.get("tokens"):
        return None
    return 100.0 * c["flops"] / (c["window_s"] * BF16_PEAK_FLOPS)
