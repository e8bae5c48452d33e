"""Per-layer metric ``mla.attn_roofline.train8k`` (%): the traced steps'
causal attention-core FLOPs (``harness.lm_work.attn_core_flops`` for each
forward call of ``lm.mla``, recomputed ones included, and twice that for
each layer's backward) over the device time of the attention kernels
(names with ``lm_work.ATTN_KERNEL_MARKS``) at the bf16 peak.  The core is
compute-bound at 8k, so the FLOPs bound it. Returns None where the run has
nothing for it to read."""

from perfbench.harness.lm_work import ATTN_KERNEL_MARKS, BF16_PEAK_FLOPS


def read(ctx):
    tr, c = ctx["trace"], ctx["counters"].get("traced")
    if not tr or not c or not c.get("attn_flops"):
        return None
    s = sum(v for n, v in tr["device_s_by_name"].items()
            if any(m in n.lower() for m in ATTN_KERNEL_MARKS))
    if s <= 0:
        return None
    return 100.0 * c["attn_flops"] / (s * BF16_PEAK_FLOPS)
