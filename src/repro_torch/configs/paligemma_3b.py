"""Copy of ``repro.configs.paligemma_3b``; only its imports differ.

paligemma-3b [vlm] — 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=257216; SigLIP vision encoder STUBBED (input_specs supplies patch
embeddings), gemma-style decoder with image-prefix attention.
[arXiv:2407.07726]"""

from repro_torch.configs.base import ArchConfig, VLMConfig, register


@register("paligemma-3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="paligemma-3b",
        family="vlm",
        n_layers=18,
        d_model=2048,
        n_heads=8,
        n_kv_heads=1,
        head_dim=256,                   # gemma-style wide heads
        d_ff=16384,
        vocab=257216,
        vlm=VLMConfig(n_patches=256, vision_dim=1152),
        act="gelu",
        source="arXiv:2407.07726",
    )
