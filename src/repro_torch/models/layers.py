"""Port of ``repro.models.layers``: norms, RoPE, attention (GQA/MQA,
causal / sliding-window / prefix-LM), dense MLPs.

Everything is a plain function over explicit parameter dicts;
gradients come from torch autograd.  Attention has two routes, as in the
reference: the plain blocked PyTorch path, and with ``use_pallas`` and no
explicit mask the hand-written CUDA ``flash_attention`` kernel
(``kernels/flash_attention``; on CPU tensors its plain version), which is
forward only and refuses autograd.

Parameter inits take a ``torch.Generator`` on the target device, draw
f32 normals there and cast, so a full-width model never passes through
the host; ``lead`` prepends stacked-layer dims (the reference vmaps its
init over layer keys).  With ``gen=None`` they draw from the global
generator, which is what ``device="meta"`` shape-only trees use.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint


# ------------------------------------------------------------------ #
# init helpers
# ------------------------------------------------------------------ #
def dense_init(gen: torch.Generator | None, shape: tuple[int, ...],
               dtype: torch.dtype, scale: float | None = None, *,
               lead: tuple[int, ...] = (),
               device: torch.device | str | None = None) -> torch.Tensor:
    """N(0, 1) * scale (default ``fan_in ** -0.5`` with ``fan_in =
    shape[0]``), drawn in f32 as ``[*lead, *shape]`` and cast to ``dtype``."""
    fan_in = shape[0] if len(shape) >= 1 else 1
    scale = scale if scale is not None else (1.0 / max(fan_in, 1)) ** 0.5
    device = gen.device if gen is not None else device
    return (torch.randn((*lead, *shape), generator=gen, dtype=torch.float32,
                        device=device) * scale).to(dtype)


def remat(fn, *args):
    """``fn(*args)``, checkpointed when grad is enabled (the reference's
    ``jax.checkpoint``): the backward recomputes ``fn``'s activations
    instead of holding them.  Without grad it is the plain call."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


# ------------------------------------------------------------------ #
# norms
# ------------------------------------------------------------------ #
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with f32 statistics; every full-size tensor stays in x's
    type, multiplied left to right as the reference does:
    ``x * inv.astype(x.dtype) * scale.astype(x.dtype)``."""
    xf = x.float()
    var = (xf * xf).sum(-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps)
    return x * inv[..., None].to(x.dtype) * scale.to(x.dtype)


# ------------------------------------------------------------------ #
# rotary position embedding
# ------------------------------------------------------------------ #
def rope_freqs(head_dim: int, theta: float,
               device: torch.device | str | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x [..., S, n, d]; positions [..., S] (broadcastable ints).  Half-split
    (not interleaved), computed in f32 and cast back."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                      # [d/2]
    angles = positions[..., None].float() * freqs               # [..., S, d/2]
    cos = torch.cos(angles)[..., None, :]                       # [..., S, 1, d/2]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# ------------------------------------------------------------------ #
# attention
# ------------------------------------------------------------------ #
def make_attn_mask(
    q_len: int,
    k_len: int,
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int = 0,
    q_offset: int = 0,
    device: torch.device | str | None = None,
) -> torch.Tensor:
    """bool[q_len, k_len]; True = attend.  ``q_offset`` shifts query
    positions (decode: q_offset = pos)."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(k_len, device=device)[None, :]
    mask = torch.ones((q_len, k_len), dtype=torch.bool, device=device)
    if causal:
        mask = kj <= qi
    if window is not None:
        mask = mask & (kj > qi - window)
    if prefix_len > 0:
        mask = mask | (kj < prefix_len)
    return mask


def gqa_attention(
    q: torch.Tensor,          # [B, Sq, H, Dh]
    k: torch.Tensor,          # [B, Sk, K, Dh]
    v: torch.Tensor,          # [B, Sk, K, Dh]
    mask: torch.Tensor | None = None,   # explicit [Sq,Sk]/[B,Sq,Sk] (decode path)
    *,
    causal: bool = False,
    window: int | None = None,
    prefix_len: int = 0,
    q_offset: int = 0,
    q_block: int = 1024,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Grouped-query attention; returns [B, Sq, H, Dh].

    With ``use_pallas`` and no explicit mask this is one launch of the CUDA
    ``flash_attention`` kernel.  Otherwise masks are built per query block
    and the scores are blocked over queries, bounding the f32 logits to
    ``B x heads x q_block x Sk``; with grad enabled each block is
    checkpointed (the reference's ``jax.checkpoint``), so the backward
    holds one block's scores at a time.
    """
    if use_pallas and mask is None:
        from repro_torch.kernels.flash_attention import ops as fa_ops
        return fa_ops.flash_attention(q, k, v, causal=causal, window=window,
                                      prefix_len=prefix_len)
    B, Sq, H, Dh = q.shape
    if mask is not None or Sq <= q_block or Sq % q_block != 0:
        return _attn_block(q, k, v, mask, causal=causal, window=window,
                           prefix_len=prefix_len, q_start=q_offset)
    def block(qb, k, v, i):
        return _attn_block(qb, k, v, None, causal=causal, window=window,
                           prefix_len=prefix_len, q_start=q_offset + i)

    outs = [remat(block, q[:, i:i + q_block], k, v, i)
            for i in range(0, Sq, q_block)]
    return torch.cat(outs, dim=1)


def _attn_block(
    q: torch.Tensor,          # [B, Sq, H, Dh]
    k: torch.Tensor, v: torch.Tensor,
    mask: torch.Tensor | None,
    *, causal: bool, window: int | None, prefix_len: int, q_start: int,
) -> torch.Tensor:
    B, Sq, H, Dh = q.shape
    Sk = k.shape[1]
    K = k.shape[2]
    R = H // K
    qg = q.reshape(B, Sq, K, R, Dh)
    scale = Dh ** -0.5
    logits = torch.einsum("bqkrd,bskd->bkrqs", qg.float() * scale, k.float())
    if mask is None:
        m = make_attn_mask(Sq, Sk, causal=causal, window=window,
                           prefix_len=prefix_len, q_offset=q_start,
                           device=q.device)
        logits = torch.where(m[None, None, None], logits,
                             torch.full_like(logits, -1e30))
    else:
        m = mask if mask.dim() == 3 else mask[None]
        logits = torch.where(m[:, None, None], logits,
                             torch.full_like(logits, -1e30))
    # f32 softmax math, then the PV product in v's type, as the reference
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bkrqs,bskd->bqkrd", probs, v)
    return out.reshape(B, Sq, H, Dh).to(q.dtype)


def attn_params_init(gen, cfg, dtype, *, lead=(), device=None) -> dict:
    D, H, K, Dh = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    kw = dict(lead=lead, device=device)
    return {
        "wq": dense_init(gen, (D, H, Dh), dtype, **kw),
        "wk": dense_init(gen, (D, K, Dh), dtype, **kw),
        "wv": dense_init(gen, (D, K, Dh), dtype, **kw),
        "wo": dense_init(gen, (H, Dh, D), dtype, (1.0 / (H * Dh)) ** 0.5, **kw),
    }


def _proj(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum("bsd,dhe->bshe", x, w)`` as one matrix product."""
    return (x @ w.reshape(w.shape[0], -1)).view(*x.shape[:-1], *w.shape[1:])


def attn_forward(
    p: dict,
    x: torch.Tensor,                # [B, S, D]
    positions: torch.Tensor,        # [B, S] (or [S])
    *,
    theta: float,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int = 0,
    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
    rope: bool = True,
    use_pallas: bool = False,
) -> torch.Tensor:
    """Self-attention ([B, S, D] -> [B, S, D]), or cross-attention when
    ``kv_override=(k, v)`` is given (precomputed by ``cross_kv``: no RoPE on
    them, and RoPE on q only if ``rope``)."""
    q = _proj(x, p["wq"])
    if kv_override is None:
        k, v = _proj(x, p["wk"]), _proj(x, p["wv"])
        if rope:
            q = apply_rope(q, positions, theta)
            k = apply_rope(k, positions, theta)
    else:
        k, v = kv_override
        if rope:
            q = apply_rope(q, positions, theta)
    out = gqa_attention(q, k, v, causal=causal, window=window,
                        prefix_len=prefix_len, use_pallas=use_pallas)
    wo = p["wo"]
    return out.reshape(*out.shape[:-2], -1) @ wo.reshape(-1, wo.shape[-1])


def cross_kv(p: dict, memory: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Cross-attention K/V from encoder memory [B, T, D]: [B, T, K, Dh] each."""
    return _proj(memory, p["wk"]), _proj(memory, p["wv"])


# ------------------------------------------------------------------ #
# dense MLPs
# ------------------------------------------------------------------ #
def mlp_params_init(gen, d_model: int, d_ff: int, act: str, dtype, *,
                    lead=(), device=None) -> dict:
    kw = dict(lead=lead, device=device)
    p = {
        "w1": dense_init(gen, (d_model, d_ff), dtype, **kw),
        "w2": dense_init(gen, (d_ff, d_model), dtype, **kw),
    }
    if act == "swiglu":
        p["w3"] = dense_init(gen, (d_model, d_ff), dtype, **kw)
    return p


def mlp_forward(p: dict, x: torch.Tensor, act: str) -> torch.Tensor:
    h = x @ p["w1"]
    if act == "swiglu":
        h = F.silu(h) * (x @ p["w3"])
    elif act == "gelu":
        h = F.gelu(h, approximate="tanh")    # jax.nn.gelu's default
    else:
        raise ValueError(f"unknown act {act}")
    return h @ p["w2"]
