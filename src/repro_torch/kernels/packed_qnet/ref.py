"""Plain PyTorch versions of ``packed_qnet_stacked`` and ``packed_qnet``:
unpack, then the dense stacked MLP.

What the wrappers run for CPU tensors, and what the kernel is held against
on the card.  ``pack_w1`` is the reference's bit-plane weight layout; the
CUDA kernel reads W1 as it is and does not need it."""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.chem.fingerprint import FP_BITS
from repro_torch.core.packed_batch import unpack_bits
from repro_torch.kernels.fused_qnet.ref import qnet_ref


def stacked_qnet_ref(x: torch.Tensor,
                     weights: Sequence[tuple[torch.Tensor, torch.Tensor]]
                     ) -> torch.Tensor:
    """x f32 [W, C, in], weights [(w [W, in, out], b [W, out])] -> q [W, C]:
    worker w's rows under worker w's layers, one ``qnet_ref`` per worker.

    Per worker, not one batched ``matmul``: a batched product's bits depend
    on how many workers share the call (the CPU BLAS blocks a batch of 1
    differently from a batch of 4), and the sharded trainer evaluates
    ``W_pad / nd`` workers a call.  So a worker's Q depends only on its own
    rows and layers, as each output of the kernel does."""
    if x.shape[0] == 0:
        return x.new_zeros(x.shape[:2])
    return torch.stack([qnet_ref(x[w], [(wt[w], bt[w]) for wt, bt in weights])
                        for w in range(x.shape[0])])


def packed_qnet_stacked_ref(bits: torch.Tensor, frac: torch.Tensor,
                            weights: Sequence[tuple[torch.Tensor, torch.Tensor]]
                            ) -> torch.Tensor:
    """bits u8 [W, C, FP_BITS/8], frac f32 [W, C] -> q f32 [W, C]."""
    x = torch.cat([unpack_bits(bits), frac.unsqueeze(-1).to(torch.float32)],
                  dim=-1)
    return stacked_qnet_ref(x, weights)


def packed_qnet_ref(bits: torch.Tensor, frac: torch.Tensor,
                    weights: Sequence[tuple[torch.Tensor, torch.Tensor]]
                    ) -> torch.Tensor:
    """One parameter set: bits u8 [N, FP_BITS/8], frac f32 [N], weights
    [(w [in, out], b [out])] -> q f32 [N]."""
    stacked = [(w.unsqueeze(0), b.unsqueeze(0)) for w, b in weights]
    return packed_qnet_stacked_ref(bits.unsqueeze(0), frac.unsqueeze(0),
                                   stacked)[0]


def pack_w1(w1: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """W1 [..., FP_BITS+1, H1] -> (w1r [..., 8, FP_BITS/8, H1], w1f [..., 1, H1])
    with ``w1r[..., k, i, :] == w1[..., 8*i + k, :]``: bit-plane k of byte i
    (MSB first) selects exactly those weight rows."""
    lead, h1 = w1.shape[:-2], w1.shape[-1]
    wbits = w1[..., :FP_BITS, :].reshape(*lead, FP_BITS // 8, 8, h1)
    return wbits.transpose(-3, -2), w1[..., FP_BITS:, :]
