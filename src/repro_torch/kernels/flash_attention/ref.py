"""Port of ``repro.kernels.flash_attention.ref``: the plain attention the
kernel is held against.

What ``ops.flash_attention`` runs for CPU tensors, and what
``chip_smoke.py`` compares the CUDA kernel with on the card.  Scores,
softmax and the product with v are all f32, as in the kernel; the
``[Sq, Sk]`` mask and scores are materialised."""

from __future__ import annotations

import torch


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
    qi = torch.arange(Sq, device=q.device)[:, None]
    kj = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((Sq, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask = kj <= qi
    if window is not None:
        mask = mask & (kj > qi - window)
    if prefix_len > 0:
        mask = mask | (kj < prefix_len)
    s = torch.where(mask[None, None], s, torch.full_like(s, -1e30))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", p, vf)
    return out.to(q.dtype)
