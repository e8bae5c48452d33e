"""moonlight-16b-a3b [mla_moe]: the port's only configuration with no twin
in the JAX package.

27 layers at d_model 2048: layer 0 a dense SwiGLU of width 11264, layers
1-26 a DeepSeek-V3 MoE (64 routed experts of width 1408, 6 a token, chosen
by sigmoid scores plus a selection bias, weights renormalised and scaled
by 2.446; 2 shared experts); every layer multi-head latent attention (16
heads, latent 512, q.k head dim 128 + a shared 64-wide RoPE key, v head
dim 128, no query compression).  Vocabulary 163,840, untied.
[hf:moonshotai/Moonlight-16B-A3B config.json, model_type deepseek_v3]

Assumed where the config says nothing: the latent RMSNorm's eps 1e-6 (the
HF DeepseekV3RMSNorm default), the bias step gamma = 0.001 (DeepSeek-V3,
arXiv:2412.19437 §2.1.2), the sequence-wise balance weight alpha = 0.001
(the HF DeepseekV3 default).  ``expert_share`` is None: every expert is
held; a deployment's device sets it (``dataclasses.replace``)."""

from repro_torch.configs.base import ArchConfig, MLAConfig, MoEConfig, register


@register("moonlight-16b-a3b")
def config() -> ArchConfig:
    return ArchConfig(
        name="moonlight-16b-a3b",
        family="mla_moe",
        n_layers=27,
        d_model=2048,
        n_heads=16,
        n_kv_heads=16,
        d_ff=1408,                      # per-expert FFN dim (moe_intermediate_size)
        vocab=163840,
        moe=MoEConfig(n_experts=64, top_k=6, routed_scale=2.446, n_shared=2,
                      first_dense=1, dense_d_ff=11264, bias_rate=1e-3, seq_aux_weight=1e-3,
                      aux_loss_weight=0.0),
        mla=MLAConfig(kv_lora_rank=512, qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128),
        rope_theta=50000.0,
        norm_eps=1e-5,
        source="hf:moonshotai/Moonlight-16B-A3B",
    )
