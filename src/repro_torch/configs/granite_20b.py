"""Copy of ``repro.configs.granite_20b``; only its imports differ.

granite-20b [dense] — 52L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; llama-arch, code.  [arXiv:2405.04324]"""

from repro_torch.configs.base import ArchConfig, register


@register("granite-20b")
def config() -> ArchConfig:
    return ArchConfig(
        name="granite-20b",
        family="dense",
        n_layers=52,
        d_model=6144,
        n_heads=48,
        n_kv_heads=1,
        d_ff=24576,
        vocab=49152,
        source="arXiv:2405.04324",
    )
