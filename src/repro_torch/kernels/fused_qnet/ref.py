"""Plain PyTorch version of ``fused_qnet``: the ``QNetwork`` forward.

What the wrapper runs for CPU tensors, and what the kernel is held
against on the card."""

from __future__ import annotations

from typing import Sequence

import torch


def qnet_ref(x: torch.Tensor,
             weights: Sequence[tuple[torch.Tensor, torch.Tensor]]) -> torch.Tensor:
    """x [N, in] f32, weights [(w [in, out], b [out])] -> q [N]."""
    h = x
    for li, (w, b) in enumerate(weights):
        h = h @ w + b
        if li < len(weights) - 1:
            h = torch.relu(h)
    return h[..., 0]
