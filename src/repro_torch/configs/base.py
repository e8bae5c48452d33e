"""Port of ``repro.configs.base``: the architecture and input-shape schema.

The same fields and defaults as the reference, so a port config and a
reference config compare equal field by field; ``jnp_dtype`` becomes
``torch_dtype``, and ``use_pallas`` keeps its name: in the port it routes
attention and the SSD scan through the hand-written CUDA kernels.

The reference's notes:

Every assigned architecture is expressed as an ``ArchConfig``; reduced
variants (for CPU smoke tests) come from ``cfg.reduced()``.  The four
assigned input shapes live in ``INPUT_SHAPES``.

Conventions:
* ``d_ff`` is the per-path FFN hidden dim (for MoE, the per-expert dim).
* ``n_kv_heads`` == ``n_heads`` means MHA; 1 means MQA.
* ``attn_window`` enables sliding-window attention (mixtral native; for the
  dense archs it is the opt-in variant that makes ``long_500k`` runnable,
  see DESIGN.md §3).
* ``family`` drives block assembly in repro.models.model.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field, replace
from typing import Callable

import torch


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    capacity_factor: float = 1.0
    group_size: int = 256           # GShard dispatch group size (tokens)
    aux_loss_weight: float = 0.01
    # port-only fields, read by the mla_moe family (DeepSeek-V3's router
    # and a dropless expert layer); the defaults leave the moe family as it is
    routed_scale: float = 1.0       # routed_scaling_factor
    n_shared: int = 0               # shared experts, one SwiGLU of n_shared x d_ff
    first_dense: int = 0            # leading dense layers (first_k_dense_replace)
    dense_d_ff: int = 0             # their SwiGLU width
    bias_rate: float = 0.0          # gamma: the selection bias's step per train step
    seq_aux_weight: float = 0.0     # alpha: the sequence-wise balance loss
    expert_share: tuple[int, int] | None = None   # (first, count) of the router's
                                    # experts held here; None: all of them

    @property
    def local_experts(self) -> tuple[int, int]:
        """(first, count) of the experts this device computes."""
        return self.expert_share or (0, self.n_experts)


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2, arXiv:2405.04434 §2.1),
    with no query compression (``q_lora_rank`` null)."""
    kv_lora_rank: int               # the latent's width
    qk_nope_head_dim: int           # per-head q.k part without position
    qk_rope_head_dim: int           # per-head RoPE part (the key's is shared)
    v_head_dim: int
    kv_norm_eps: float = 1e-6       # the latent's RMSNorm


@dataclass(frozen=True)
class SSMConfig:
    state_dim: int                  # N
    head_dim: int = 64              # P
    expand: int = 2                 # d_inner = expand * d_model
    conv_width: int = 4
    chunk: int = 256                # SSD chunk length
    n_groups: int = 1               # B/C groups (Mamba2 'ngroups')


@dataclass(frozen=True)
class EncDecConfig:
    n_enc_layers: int
    n_frames: int = 1500            # whisper encoder positions (stub frontend)


@dataclass(frozen=True)
class VLMConfig:
    n_patches: int = 256            # SigLIP-stub prefix length
    vision_dim: int = 1152          # stub embedding dim before projector


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
                                    # | mla_moe (port-only)
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None     # default d_model // n_heads
    moe: MoEConfig | None = None
    ssm: SSMConfig | None = None
    encdec: EncDecConfig | None = None
    vlm: VLMConfig | None = None
    mla: MLAConfig | None = None    # port-only: the mla_moe family's attention
    shared_attn_every: int = 0      # hybrid: shared attn period (0 = none)
    attn_window: int | None = None  # sliding-window size (None = full)
    rope_theta: float = 1e6
    norm_eps: float = 1e-5
    act: str = "swiglu"             # swiglu | gelu
    tied_embeddings: bool = False
    dtype: str = "bfloat16"         # params/activations for lowering
    remat: bool = True              # activation-checkpoint each block
    use_pallas: bool = False        # route attention/ssd through kernels
    seq_shard: bool = False         # sequence-parallel activations (beyond-paper
                                    # §Perf option: shard the token dim over
                                    # "model" between attention/MLP blocks)
    source: str = ""                # citation

    # ---------------------------------------------------------- #
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim if self.head_dim is not None else self.d_model // self.n_heads

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def reduced(self) -> "ArchConfig":
        """CPU-smoke variant: <=2 layers, d_model<=512, <=4 experts —
        same family and block structure."""
        d_model = min(self.d_model, 256)
        n_heads = min(self.n_heads, 4)
        kv = min(self.n_kv_heads, n_heads)
        changes: dict = dict(
            n_layers=min(self.n_layers, 2),
            d_model=d_model,
            n_heads=n_heads,
            n_kv_heads=kv,
            head_dim=max(d_model // n_heads, 8),
            d_ff=min(self.d_ff, 512),
            vocab=min(self.vocab, 512),
            dtype="float32",
            remat=False,
        )
        if self.moe is not None:
            changes["moe"] = replace(self.moe, n_experts=min(self.moe.n_experts, 4),
                                     top_k=min(self.moe.top_k, 2), group_size=32,
                                     dense_d_ff=min(self.moe.dense_d_ff, 512),
                                     expert_share=None)
        if self.mla is not None:
            m = self.mla
            changes["mla"] = replace(m, kv_lora_rank=min(m.kv_lora_rank, 32),
                                     qk_nope_head_dim=min(m.qk_nope_head_dim, 16),
                                     qk_rope_head_dim=min(m.qk_rope_head_dim, 8),
                                     v_head_dim=min(m.v_head_dim, 16))
        if self.ssm is not None:
            changes["ssm"] = replace(self.ssm, state_dim=min(self.ssm.state_dim, 16),
                                     head_dim=16, chunk=16)
        if self.encdec is not None:
            changes["encdec"] = replace(self.encdec, n_enc_layers=2, n_frames=16)
        if self.vlm is not None:
            changes["vlm"] = replace(self.vlm, n_patches=8, vision_dim=32)
        if self.shared_attn_every:
            changes["shared_attn_every"] = 2
        return replace(self, **changes)

    def with_window(self, window: int) -> "ArchConfig":
        return replace(self, attn_window=window)


@dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str                       # train | prefill | decode


INPUT_SHAPES: dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


_REGISTRY: dict[str, Callable[[], ArchConfig]] = {}


def register(name: str):
    def deco(fn: Callable[[], ArchConfig]):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ArchConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> list[str]:
    return sorted(_REGISTRY)
