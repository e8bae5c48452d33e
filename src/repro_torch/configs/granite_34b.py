"""Copy of ``repro.configs.granite_34b``; only its imports differ.

granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; llama-arch, code.  [arXiv:2405.04324]"""

from repro_torch.configs.base import ArchConfig, register


@register("granite-34b")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-34b",
        family="dense",
        n_layers=88,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        source="arXiv:2405.04324",
    )
