"""Copy of ``repro.configs.zamba2_1p2b``; only its imports differ.

zamba2-1.2b [hybrid] — 38L d_model=2048 32H (GQA kv=32) d_ff=8192
vocab=32000, ssm_state=64; Mamba2 blocks + shared attention blocks.
[arXiv:2411.15242]"""

from repro_torch.configs.base import ArchConfig, SSMConfig, register


@register("zamba2-1.2b")
def config() -> ArchConfig:
    return ArchConfig(
        name="zamba2-1.2b",
        family="hybrid",
        n_layers=38,
        d_model=2048,
        n_heads=32,
        n_kv_heads=32,
        d_ff=8192,
        vocab=32000,
        ssm=SSMConfig(state_dim=64),
        shared_attn_every=6,            # one shared attn block applied every 6 layers
        source="arXiv:2411.15242",
    )
