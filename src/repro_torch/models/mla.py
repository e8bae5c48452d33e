"""Multi-head latent attention (MLA; DeepSeek-V2, arXiv:2405.04434 §2.1),
as Moonlight-16B-A3B runs it: no query compression (``q_lora_rank``
null), so every head's query comes from one projection.

    q      = x wq                     [B, S, H, dn + dr]   (nope | rope)
    c, kr  = x wkv_a                  [B, S, r] and [B, S, dr]
    c      = rms_norm(c, kv_norm)
    k, v   = c wkv_b                  [B, S, H, dn] and [B, S, H, dv]
    k      = k | rope(kr), the one RoPE key shared by every head
    out    = softmax(q k^T / sqrt(dn + dr)) v, causal;  y = out wo

RoPE rotates interleaved pairs (x0, x1), (x2, x3), ... of the 64-wide
parts, the published pairing (the HF DeepseekV3 code permutes its weight
rows to rotate halves; this is the same map).  The q.k head dim (192)
differs from v's (128); the core is ``F.scaled_dot_product_attention``,
which has a backward (the port's ``flash_attention`` kernel is forward
only and takes one head dim).  The latent is materialised per layer; the
latent decode cache is not written yet (``models.model.init_cache``
raises for the family).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import _proj, dense_init, rms_norm


def mla_params_init(gen, cfg, dtype, *, lead=(), device=None) -> dict:
    """wq [D, H, dn+dr], wkv_a [D, r+dr], kv_norm [r] (f32), wkv_b [r, H,
    dn+dv], wo [H, dv, D]."""
    m, D, H = cfg.mla, cfg.d_model, cfg.n_heads
    dqk = m.qk_nope_head_dim + m.qk_rope_head_dim
    kw = dict(lead=lead, device=device)
    return {
        "wq": dense_init(gen, (D, H, dqk), dtype, **kw),
        "wkv_a": dense_init(gen, (D, m.kv_lora_rank + m.qk_rope_head_dim), dtype, **kw),
        "kv_norm": torch.ones((*lead, m.kv_lora_rank), dtype=torch.float32,
                              device=device),
        "wkv_b": dense_init(gen, (m.kv_lora_rank, H, m.qk_nope_head_dim + m.v_head_dim),
                            dtype, **kw),
        "wo": dense_init(gen, (H, m.v_head_dim, D), dtype,
                         (1.0 / (H * m.v_head_dim)) ** 0.5, **kw),
    }


def rope_interleaved(x: torch.Tensor, positions: torch.Tensor,
                     theta: float) -> torch.Tensor:
    """x [B, S, n, d]; positions [B, S].  Pair i = (x[2i], x[2i+1]) turns by
    ``positions * theta ** (-2i / d)``; computed in f32, cast back."""
    d = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                          device=x.device) / d))
    ang = positions[..., None].float() * freqs                  # [B, S, d/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    xf = x.float().unflatten(-1, (d // 2, 2))
    x0, x1 = xf[..., 0], xf[..., 1]
    out = torch.stack([x0 * cos - x1 * sin, x0 * sin + x1 * cos], dim=-1)
    return out.flatten(-2).to(x.dtype)


def mla_forward(p: dict, x: torch.Tensor, positions: torch.Tensor, cfg) -> torch.Tensor:
    """Causal self-attention of one layer: x [B, S, D] -> [B, S, D]."""
    m, H = cfg.mla, cfg.n_heads
    dn, dr, r = m.qk_nope_head_dim, m.qk_rope_head_dim, m.kv_lora_rank
    q = _proj(x, p["wq"])                                       # [B,S,H,dn+dr]
    q = torch.cat([q[..., :dn], rope_interleaved(q[..., dn:], positions,
                                                 cfg.rope_theta)], dim=-1)
    ckv = x @ p["wkv_a"]                                        # [B,S,r+dr]
    c = rms_norm(ckv[..., :r], p["kv_norm"], m.kv_norm_eps)
    k_pe = rope_interleaved(ckv[..., None, r:], positions, cfg.rope_theta)
    kv = _proj(c, p["wkv_b"])                                   # [B,S,H,dn+dv]
    k = torch.cat([kv[..., :dn], k_pe.expand(*k_pe.shape[:2], H, dr)], dim=-1)
    v = kv[..., dn:]
    out = F.scaled_dot_product_attention(
        q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
        is_causal=True, scale=(dn + dr) ** -0.5)                # [B,H,S,dv]
    wo = p["wo"]
    return out.transpose(1, 2).flatten(2) @ wo.reshape(-1, wo.shape[-1])
