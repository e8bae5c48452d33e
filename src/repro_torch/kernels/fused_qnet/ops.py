"""``fused_qnet``: the five-layer MolDQN Q-network over candidate rows.

A network of 2 to 4 layers runs through the same kernel, padded to five
with identity layers that change no bit (``kernels/qnet_depth.py``).

On a CUDA tensor it launches the hand-written kernel
(``csrc/fused_qnet.cu``) on the current stream, or raises; on a CPU
tensor it runs the plain version (``ref.qnet_ref``).  Rows need no
padding: the kernel masks a ragged N.  ``fused_qnet.launches`` counts the
kernel launches, so a run can show that its Q dispatches went through it.
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.fused_qnet import build
from repro_torch.kernels.fused_qnet.ref import qnet_ref
from repro_torch.kernels.qnet_depth import pad_to_kernel_depth

N_LAYERS = 5


def _check(x: torch.Tensor, weights) -> None:
    if len(weights) != N_LAYERS:
        raise ValueError(f"fused_qnet takes the {N_LAYERS}-layer MolDQN MLP, "
                         f"got {len(weights)} layers")
    if x.dim() != 2:
        raise ValueError(f"x must be [N, in_dim], got {tuple(x.shape)}")
    width = x.shape[1]
    for li, (w, b) in enumerate(weights):
        for name, t in (("w", w), ("b", b)):
            if t.device != x.device or t.dtype != torch.float32 \
                    or not t.is_contiguous():
                raise ValueError(
                    f"layer {li} {name}: need contiguous float32 on {x.device}, "
                    f"got {t.dtype} on {t.device}")
        if w.dim() != 2 or w.shape[0] != width or tuple(b.shape) != (w.shape[1],):
            raise ValueError(f"layer {li}: w {tuple(w.shape)}, b {tuple(b.shape)} "
                             f"do not follow width {width}")
        width = w.shape[1]
    if width != 1:
        raise ValueError(f"the last layer must have width 1, got {width}")
    if x.dtype != torch.float32 or not x.is_contiguous():
        raise ValueError(f"x must be contiguous float32, got {x.dtype}")
    if x.numel() >= 2 ** 31:
        raise ValueError(f"x has {x.numel()} elements; the kernel indexes "
                         f"rows with 32-bit ints")


def fused_qnet(weights: Sequence[tuple[torch.Tensor, torch.Tensor]],
               x: torch.Tensor) -> torch.Tensor:
    """weights ``[(w [in, out], b [out])] x 5``, x f32 ``[N, in]`` -> q ``[N]``."""
    if x.device.type == "cpu":
        return qnet_ref(x, weights)
    if x.device.type != "cuda":
        raise ValueError(f"fused_qnet runs on cuda or cpu, got {x.device}")
    weights = pad_to_kernel_depth(weights)
    _check(x, weights)
    n = x.shape[0]
    q = torch.empty(n, device=x.device, dtype=torch.float32)
    if n == 0:
        return q
    # h1..h4 go back to the caching allocator when this returns, while the
    # launches may still run: safe, because the allocator hands a block out
    # again only in stream order on the same stream
    hidden = [torch.empty((n, w.shape[1]), device=x.device, dtype=torch.float32)
              for w, _ in weights[:-1]]
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.fused_qnet_forward(
            x.data_ptr(), *[t.data_ptr() for wb in weights for t in wb],
            *[h.data_ptr() for h in hidden], q.data_ptr(),
            n, x.shape[1], *[h.shape[1] for h in hidden], stream)
    if err != 0:
        raise RuntimeError(f"fused_qnet launch failed: CUDA error {err} "
                           f"({lib.fused_qnet_error_string(err).decode()})")
    fused_qnet.launches += 1
    return q


fused_qnet.launches = 0
