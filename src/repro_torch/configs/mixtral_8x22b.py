"""Copy of ``repro.configs.mixtral_8x22b``; only its imports differ.

mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, sliding-window attention.
[arXiv:2401.04088]"""

from repro_torch.configs.base import ArchConfig, MoEConfig, register


@register("mixtral-8x22b")
def config() -> ArchConfig:
    return ArchConfig(
        name="mixtral-8x22b",
        family="moe",
        n_layers=56,
        d_model=6144,
        n_heads=48,
        n_kv_heads=8,
        d_ff=16384,
        vocab=32768,
        moe=MoEConfig(n_experts=8, top_k=2),
        attn_window=4096,               # SWA (native; makes long_500k runnable)
        source="arXiv:2401.04088",
    )
