"""The work a cell does, counted from shapes, and the H100's peaks.

The Q-network is f32 with TF32 off, so its peak is the f32 FFMA rate, not
bf16's.  These counts stay the same whatever implements a kernel, so a
later change to the kernel is read against the same yardstick."""

from __future__ import annotations

# NVIDIA H100 SXM (data sheet, dense, 700 W): f32 outside the tensor cores
# and HBM3 bandwidth
F32_PEAK_FLOPS = 66.9e12
HBM_BYTES_PER_S = 3.35e12
F32_BYTES = 4


def qnet_row_flops(sizes) -> int:
    """FLOPs of one forward row: 2 x sum(in x out) (biases and ReLUs are
    not counted)."""
    return 2 * sum(i * o for i, o in zip(sizes[:-1], sizes[1:]))


def qnet_params(sizes) -> int:
    return sum(i * o + o for i, o in zip(sizes[:-1], sizes[1:]))


def learner_update_flops(sizes, batch: int, candidates: int) -> int:
    """One worker's double-DQN update: no-grad forwards of the online and
    the target network over the batch x candidates next-state rows, the
    batch's state rows forward, weight gradients at every layer and input
    gradients at every layer but the first."""
    f = qnet_row_flops(sizes)
    first = 2 * sizes[0] * sizes[1]
    return 2 * batch * candidates * f + batch * f + batch * f + batch * (f - first)


def qnet_dispatch_bound_s(sizes, rows: int) -> float:
    """The least time one Q dispatch over ``rows`` real rows can take: the
    larger of its FLOPs at the f32 peak and its bytes (the weights once,
    each real row's input and output once) at HBM bandwidth."""
    flops = rows * qnet_row_flops(sizes)
    nbytes = F32_BYTES * (qnet_params(sizes) + rows * (sizes[0] + 1))
    return max(flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)


def packed_dispatch_bound_s(sizes, rows: int, workers: int) -> float:
    """The least time one fleet dispatch of ``packed_qnet_stacked`` can
    take: ``rows`` real candidate rows, each read as its packed fingerprint
    (1 bit a feature, the steps-left feature as f32) and written as one
    f32, under each of ``workers`` workers' own weights, read once."""
    flops = rows * qnet_row_flops(sizes)
    nbytes = workers * F32_BYTES * qnet_params(sizes) \
        + rows * ((sizes[0] - 1) // 8 + 2 * F32_BYTES)
    return max(flops / F32_PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
