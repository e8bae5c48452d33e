"""Copy of ``repro.configs.whisper_large_v3``; only its imports differ.

whisper-large-v3 [audio] — 32L d_model=1280 20H (MHA) d_ff=5120
vocab=51866; enc-dec, conv/mel frontend STUBBED (input_specs supplies
precomputed frame embeddings).  [arXiv:2212.04356]"""

from repro_torch.configs.base import ArchConfig, EncDecConfig, register


@register("whisper-large-v3")
def config() -> ArchConfig:
    return ArchConfig(
        name="whisper-large-v3",
        family="encdec",
        n_layers=32,                    # decoder layers
        d_model=1280,
        n_heads=20,
        n_kv_heads=20,
        d_ff=5120,
        vocab=51866,
        encdec=EncDecConfig(n_enc_layers=32, n_frames=1500),
        act="gelu",
        rope_theta=1e4,                 # (whisper uses learned pos; RoPE stands in)
        source="arXiv:2212.04356",
    )
