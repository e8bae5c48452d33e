"""Per-layer metric ``moe.experts_roofline.train8k`` (%): the traced
steps' local expert FLOPs (``lm.moe.local_rows`` pairs x
``harness.lm_work.expert_row_flops``, forward and recomputed calls) over
the device time of the kernels launched inside the program's
``lm.moe.experts`` span, at the bf16 peak. Returns None where the run has
nothing for it to read."""

from perfbench.harness.lm_work import BF16_PEAK_FLOPS


def read(ctx):
    c = ctx["counters"].get("traced")
    if not c or not c.get("expert_flops"):
        return None
    s = c["span_device_s"].get("lm.moe.experts", 0.0)
    if s <= 0:
        return None
    return 100.0 * c["expert_flops"] / (s * BF16_PEAK_FLOPS)
