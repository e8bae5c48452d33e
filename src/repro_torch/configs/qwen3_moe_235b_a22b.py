"""Copy of ``repro.configs.qwen3_moe_235b_a22b``; only its imports differ.

qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) d_ff=1536
vocab=151936, MoE 128 experts top-8.  [hf:Qwen/Qwen3-30B-A3B]"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("qwen3-moe-235b-a22b")
def config() -> ArchConfig:
    return ArchConfig(
        name="qwen3-moe-235b-a22b",
        family="moe",
        n_layers=94,
        d_model=4096,
        n_heads=64,
        n_kv_heads=4,
        head_dim=128,
        d_ff=1536,                      # per-expert FFN dim
        vocab=151936,
        moe=MoEConfig(n_experts=128, top_k=8),
        rope_theta=1e6,
        source="hf:Qwen/Qwen3-30B-A3B",
    )
