"""Port of ``repro.kernels.flash_attention.ref``: the plain attention the
kernel is held against.

What ``ops.flash_attention`` runs for CPU tensors, and what
``chip_smoke.py`` compares the CUDA kernel with on the card.  Scores,
softmax and the product with v are all f32, as in the kernel; the
``[Sq, Sk]`` mask and scores are materialised.

``tile_live`` and ``tile_full`` mirror the kernel's tile rules
(``csrc/flash_attention.cu``) for the tests; nothing on a path calls
them."""

from __future__ import annotations

import torch


def attn_mask(sq: int, sk: int, *, causal: bool, window: int | None,
              prefix_len: int, device=None) -> torch.Tensor:
    """The ``[sq, sk]`` bool mask of valid (query, key) pairs."""
    qi = torch.arange(sq, device=device)[:, None]
    kj = torch.arange(sk, device=device)[None, :]
    mask = torch.ones((sq, sk), dtype=torch.bool, device=device)
    if causal:
        mask = kj <= qi
    if window is not None:
        mask = mask & (kj > qi - window)
    if prefix_len > 0:
        mask = mask | (kj < prefix_len)
    return mask


def attention_ref(
    q: torch.Tensor,   # [B, H, Sq, D]
    k: torch.Tensor,   # [B, K, Sk, D]
    v: torch.Tensor,
    *,
    causal: bool = True,
    window: int | None = None,
    prefix_len: int = 0,
) -> torch.Tensor:
    B, H, Sq, D = q.shape
    K, Sk = k.shape[1], k.shape[2]
    rep = H // K
    kf = torch.repeat_interleave(k, rep, dim=1).float()
    vf = torch.repeat_interleave(v, rep, dim=1).float()
    s = torch.einsum("bhqd,bhkd->bhqk", q.float() * D ** -0.5, kf)
    mask = attn_mask(Sq, Sk, causal=causal, window=window,
                     prefix_len=prefix_len, device=q.device)
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.to(q.dtype)


BQ, BK = 128, 64   # the bf16 kernel's query tile (8 warps x 16 rows) and key tile


def tile_live(q0: int, qmax: int, k0: int, sk: int, *, causal: bool,
              window: int | None, prefix_len: int, bk: int = BK) -> bool:
    """Could any pair of query rows ``[q0, qmax]`` and keys ``[k0, k0 + bk)``
    be valid?  The kernel skips a key tile for which this is false."""
    kmax = min(k0 + bk, sk) - 1
    if prefix_len > 0 and k0 < min(prefix_len, sk):
        return True
    if causal and k0 > qmax:
        return False
    if window is not None and kmax <= q0 - window:
        return False
    return True


def tile_full(q0: int, qmax: int, k0: int, sk: int, *, causal: bool,
              window: int | None, prefix_len: int, bk: int = BK) -> bool:
    """Is every pair of query rows ``[q0, qmax]`` and keys ``[k0, k0 + bk)``
    valid?  The kernel evaluates no per-element mask on such a tile."""
    kmax = k0 + bk - 1
    if kmax >= sk:
        return False
    if prefix_len > 0 and kmax < prefix_len:
        return True
    if causal and kmax > q0:
        return False
    if window is not None and k0 <= qmax - window:
        return False
    return True
