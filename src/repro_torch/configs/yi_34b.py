"""Copy of ``repro.configs.yi_34b``; only its imports differ.

yi-34b [dense] — 60L d_model=7168 56H (GQA kv=8) d_ff=20480 vocab=64000;
llama-arch GQA.  [arXiv:2403.04652]"""

from repro_torch.configs.base import ArchConfig, register


@register("yi-34b")
def config() -> ArchConfig:
    return ArchConfig(
        name="yi-34b",
        family="dense",
        n_layers=60,
        d_model=7168,
        n_heads=56,
        n_kv_heads=8,
        d_ff=20480,
        vocab=64000,
        rope_theta=5e6,
        source="arXiv:2403.04652",
    )
