"""Copy of ``repro.configs.mamba2_2p7b``; only its imports differ.

mamba2-2.7b [ssm] — 64L d_model=2560 (attn-free) vocab=50280,
ssm_state=128; SSD (state-space duality).  [arXiv:2405.21060]"""

from repro_torch.configs.base import ArchConfig, SSMConfig, register


@register("mamba2-2.7b")
def config() -> ArchConfig:
    return ArchConfig(
        name="mamba2-2.7b",
        family="ssm",
        n_layers=64,
        d_model=2560,
        n_heads=1,                      # attn-free; unused
        n_kv_heads=1,
        d_ff=0,                         # no FFN blocks (mamba2 arch)
        vocab=50280,
        ssm=SSMConfig(state_dim=128),
        tied_embeddings=True,
        source="arXiv:2405.21060",
    )
