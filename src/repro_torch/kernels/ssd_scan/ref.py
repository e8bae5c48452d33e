"""Port of ``repro.kernels.ssd_scan.ref``: the naive O(L) recurrence.

Deliberately NOT the chunked algorithm (that's what both the kernel and
``repro_torch.models.ssm.ssd_chunked`` implement): testing chunked against
chunked would hide shared algebra bugs.  This is the definitional
recurrence, in f32:

    S_t = exp(-A dt_t) S_{t-1} + dt_t x_t B_t^T ;  y_t = C_t S_t

What ``ops.ssd_scan`` runs for CPU tensors, and what ``chip_smoke.py``
compares the CUDA kernel with on the card (one Python step per position).
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
