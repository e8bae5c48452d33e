"""The LM training cell's work, counted from shapes, and the H100's bf16
peak.  These counts stay the same whatever implements a kernel, so a
later change is read against the same yardstick.  ``d`` is the
reference's ``Dims`` (perfbench/reference/moonlight.py)."""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, 700 W): bf16 dense tensor-core rate
BF16_PEAK_FLOPS = 989e12

# device kernels of the attention core, by name: the flash, memory-efficient
# (cutlass "fmha") and cuDNN back ends of scaled_dot_product_attention
ATTN_KERNEL_MARKS = ("flash", "fmha", "attention", "sdpa", "attn")


def mla_weights(d) -> int:
    """One MLA layer's projection weights: wq, wkv_a, wkv_b, wo."""
    D, H, r = d.d_model, d.n_heads, d.kv_lora_rank
    return (D * H * (d.qk_nope + d.qk_rope) + D * (r + d.qk_rope)
            + r * H * (d.qk_nope + d.v_dim) + H * d.v_dim * D)


def expert_row_flops(d) -> int:
    """One (token, expert) pair's forward through a SwiGLU expert."""
    return 2 * 3 * d.d_model * d.d_ff


def attn_core_flops(d, batch: int, seq: int) -> float:
    """One layer's causal attention core, forward: q.k over the (S^2 + S) / 2
    pairs of each head at q.k width qk_nope + qk_rope, and p.v at v's width."""
    pairs = batch * d.n_heads * seq * (seq + 1) / 2
    return 2.0 * pairs * (d.qk_nope + d.qk_rope + d.v_dim)


def dense_weights_per_token(d) -> int:
    """Weights every token passes through, forward (the embedding is a
    lookup): every layer's MLA, the leading dense SwiGLUs, each MoE layer's
    router and shared experts, and the output head."""
    n_moe = d.n_layers - d.first_dense
    return (d.n_layers * mla_weights(d) + d.first_dense * 3 * d.d_model * d.dense_d_ff
            + n_moe * (d.d_model * d.n_experts + 3 * d.d_model * d.n_shared * d.d_ff)
            + d.d_model * d.vocab)


def step_model_flops(d, batch: int, seq: int, routed_pairs: float) -> float:
    """Model FLOPs of one train step, forward and backward, recomputation
    not counted: 6 x the weights each token passes through, 3 x the routed
    pairs' forward, and 3 x every layer's attention core."""
    tokens = batch * seq
    return (6.0 * dense_weights_per_token(d) * tokens
            + 3.0 * expert_row_flops(d) * routed_pairs
            + 3.0 * d.n_layers * attn_core_flops(d, batch, seq))
