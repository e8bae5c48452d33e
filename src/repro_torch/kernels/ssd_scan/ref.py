"""Port of ``repro.kernels.ssd_scan.ref``: the naive O(L) recurrence.

Deliberately NOT the chunked algorithm (that's what both the kernel and
``repro_torch.models.ssm.ssd_chunked`` implement): testing chunked against
chunked would hide shared algebra bugs.  This is the definitional
recurrence, in f32:

    S_t = exp(-A dt_t) S_{t-1} + dt_t x_t B_t^T ;  y_t = C_t S_t

What ``ops.ssd_scan`` runs for CPU tensors, and what ``chip_smoke.py``
compares the CUDA kernel with on the card (one Python step per position).

``ssd_stages`` is the kernel's own decomposition in plain PyTorch: its three
stages (chunk summaries, the pass over chunk states, the chunks' outputs)
with the bf16 route's rounding points.  The tests hold it against
``ssd_ref`` and the reference's Pallas kernel, so an error in the
decomposition's algebra shows on the CPU; ``chip_smoke.py`` holds the CUDA
kernel against it on the card, at a tolerance tighter than ``ssd_ref``'s,
so the kernel and this copy cannot drift apart.
"""

from __future__ import annotations

import torch


def ssd_ref(
    x: torch.Tensor,    # [B, L, H, P]
    dt: torch.Tensor,   # [B, L, H]
    A: torch.Tensor,    # [H]
    B_: torch.Tensor,   # [B, L, G, N]
    C_: torch.Tensor,   # [B, L, G, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    rep = H // G
    Bh = torch.repeat_interleave(B_, rep, dim=2).float()
    Ch = torch.repeat_interleave(C_, rep, dim=2).float()
    xf = x.float()
    dtf = dt.float()
    Af = A.float()

    S = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(L):
        a = torch.exp(-Af[None, :] * dtf[:, t])                    # [B, H]
        S = a[..., None, None] * S + torch.einsum(
            "bhp,bh,bhn->bhpn", xf[:, t], dtf[:, t], Bh[:, t])
        ys.append(torch.einsum("bhn,bhpn->bhp", Ch[:, t], S))
    y = torch.stack(ys, dim=1)                                      # [B, L, H, P]
    return y.to(x.dtype), S.to(x.dtype)


def _split_bf16(v: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """v = hi + lo with hi = bf16(v), lo = bf16(v - hi), both back in f32."""
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def ssd_stages(
    x: torch.Tensor,    # [B, L, H, P]
    dt: torch.Tensor,   # [B, L, H]
    A: torch.Tensor,    # [H]
    B_: torch.Tensor,   # [B, L, G, N]
    C_: torch.Tensor,   # [B, L, G, N]
    chunk: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """``csrc/ssd_scan.cu``'s three launches, in f32, rounding where its
    bf16 route rounds when x is bf16: the f32 operand of the chunk summary
    (w x) and of the carry-in (the entering state) split into bf16 hi + lo,
    and the gated scores G rounded to bf16 before G x."""
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    Q = min(chunk, L)
    nc = L // Q
    bf16 = x.dtype == torch.bfloat16
    rep = H // G
    xc = x.float().reshape(Bb, nc, Q, H, P)
    dtc = dt.float().reshape(Bb, nc, Q, H)
    Bh = torch.repeat_interleave(B_, rep, dim=2).float().reshape(Bb, nc, Q, H, N)
    Ch = torch.repeat_interleave(C_, rep, dim=2).float().reshape(Bb, nc, Q, H, N)

    # 1. chunk_state: cum, and each chunk's summary sum_u w_u x_u B_u^T
    cum = torch.cumsum(-A.float() * dtc, dim=2)                   # [B,nc,Q,H]
    total = cum[:, :, -1]                                         # [B,nc,H]
    wx = xc * (torch.exp(total[:, :, None] - cum) * dtc)[..., None]
    parts = _split_bf16(wx) if bf16 else (wx,)
    summary = sum(torch.einsum("bcuhp,bcuhn->bchpn", part, Bh) for part in parts)

    # 2. state_pass: the state entering each chunk, and the final state
    S = torch.zeros((Bb, H, P, N), dtype=torch.float32, device=x.device)
    entering = []
    for c in range(nc):
        entering.append(S)
        S = torch.exp(total[:, c])[..., None, None] * S + summary[:, c]
    entering = torch.stack(entering, dim=1)                       # [B,nc,H,P,N]

    # 3. chunk_scan: carry-in, then the gated scores times x
    parts = _split_bf16(entering) if bf16 else (entering,)
    carry = sum(torch.einsum("bcqhn,bchpn->bcqhp", Ch, part) for part in parts)
    y = carry * torch.exp(cum)[..., None]
    scores = torch.einsum("bcqhn,bcshn->bchqs", Ch, Bh)
    cum_h = cum.permute(0, 1, 3, 2)                               # [B,nc,H,Q]
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    decay = torch.where(causal, cum_h[..., :, None] - cum_h[..., None, :],
                        torch.full_like(scores, -torch.inf))
    gate = scores * torch.exp(decay) * dtc.permute(0, 1, 3, 2)[..., None, :]
    if bf16:
        gate = gate.to(torch.bfloat16).float()
    y = y + torch.einsum("bchqs,bcshp->bcqhp", gate, xc)
    return y.reshape(Bb, L, H, P).to(x.dtype), S.to(x.dtype)
