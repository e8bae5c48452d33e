"""Shallower Q networks through the five-layer Q kernels.

``fused_qnet`` and ``packed_qnet`` take the five-layer MolDQN MLP, as the
reference's Pallas kernels do.  The reference runs other depths (the
examples' hidden sizes (256, 64) and (512, 128, 32), the truth run's
default (32,)) through plain XLA; on the card the port's path is the
kernel, so a network of 2 to 4 layers is padded to five with identity
layers after its last hidden layer.

That changes no bit.  The last hidden layer's output h is >= 0 after its
ReLU; each output of an identity layer is one thread's ``fmaf`` chain that
adds h_j * 1 to exact zeros and a zero bias, and ReLU leaves it as it is.
(A non-finite h would turn the zero products into NaN; a network with
finite weights and inputs has none.)  The identity layers are made once
per width, worker count and device.
"""

from __future__ import annotations

import functools
from typing import Sequence

import torch

DEPTH = 5


@functools.lru_cache(maxsize=16)
def _identity(lead: tuple[int, ...], width: int,
              device: torch.device) -> tuple[torch.Tensor, torch.Tensor]:
    eye = torch.eye(width, dtype=torch.float32, device=device)
    eye = eye.expand(lead + (width, width)).contiguous()
    return eye, torch.zeros(lead + (width,), dtype=torch.float32, device=device)


def pad_to_kernel_depth(weights: Sequence[tuple[torch.Tensor, torch.Tensor]]
                        ) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """``[(w [..., in, out], b [..., out])]`` of 2 to 5 layers -> five
    layers computing the same function bit for bit; other depths are
    returned as they are, for the kernel's own check to refuse."""
    weights = list(weights)
    if not 2 <= len(weights) < DEPTH:
        return weights
    w, _ = weights[-2]
    eye = _identity(tuple(w.shape[:-2]), int(w.shape[-1]), w.device)
    return weights[:-1] + [eye] * (DEPTH - len(weights)) + weights[-1:]
