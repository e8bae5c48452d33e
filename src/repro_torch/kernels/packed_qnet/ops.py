"""``packed_qnet_stacked``: the fleet's per-worker Q-network over candidate
rows; ``packed_qnet``: the same over packed rows under one parameter set.

On CUDA tensors the wrappers launch the hand-written kernel
(``csrc/packed_qnet.cu``) on the current stream, or raise; on CPU tensors
they run the plain version (``ref.py``).  ``packed_qnet_stacked`` reads
packed fingerprint planes, ``dense_qnet_stacked`` dense f32 rows; both are
one launch of the same tiles and give the same bits on the same rows.
``packed_qnet`` is the packed launch with W = 1.  A ragged C needs no
padding: the kernel masks it.  Each wrapper counts its kernel launches
(``packed_qnet_stacked.launches``), so a run can show that its Q
dispatches went through the kernel.  A network of 2 to 4 layers runs
through the same kernel, padded to five with identity layers that change
no bit (``kernels/qnet_depth.py``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from repro_torch.kernels.packed_qnet import build
from repro_torch.kernels.packed_qnet.ref import (packed_qnet_ref,
                                                 packed_qnet_stacked_ref,
                                                 stacked_qnet_ref)
from repro_torch.kernels.qnet_depth import pad_to_kernel_depth

N_LAYERS = 5

Weights = Sequence[tuple[torch.Tensor, torch.Tensor]]


def _check_weights(weights, n_workers: int, width: int,
                   device: torch.device) -> None:
    if len(weights) != N_LAYERS:
        raise ValueError(f"the kernel takes the {N_LAYERS}-layer MolDQN MLP, "
                         f"got {len(weights)} layers")
    for li, (w, b) in enumerate(weights):
        for name, t in (("w", w), ("b", b)):
            if t.device != device or t.dtype != torch.float32 \
                    or not t.is_contiguous():
                raise ValueError(
                    f"layer {li} {name}: need contiguous float32 on {device}, "
                    f"got {t.dtype} on {t.device}")
        if w.dim() != 3 or w.shape[0] != n_workers or w.shape[1] != width \
                or tuple(b.shape) != (n_workers, w.shape[2]):
            raise ValueError(
                f"layer {li}: w {tuple(w.shape)}, b {tuple(b.shape)} do not "
                f"follow [{n_workers}, {width}, out] / [{n_workers}, out]")
        width = w.shape[2]
    if width != 1:
        raise ValueError(f"the last layer must have width 1, got {width}")


def _check_rows(t: torch.Tensor, name: str, dtype: torch.dtype, dim: int) -> None:
    if t.dtype != dtype or not t.is_contiguous() or t.dim() != dim:
        raise ValueError(f"{name} must be contiguous {dtype} of rank {dim}, got "
                         f"{t.dtype} {tuple(t.shape)}")
    if t.numel() >= 2 ** 31:
        raise ValueError(f"{name} has {t.numel()} elements; the kernel indexes "
                         f"a worker's rows with 32-bit ints")


def _device(t: torch.Tensor) -> str:
    if t.device.type not in ("cuda", "cpu"):
        raise ValueError(f"packed_qnet_stacked runs on cuda or cpu, got {t.device}")
    return t.device.type


def _launch(fn_name: str, a_ptrs: list[int], weights: Weights, n_workers: int,
            c: int, k_arg: int, device: torch.device) -> torch.Tensor:
    q = torch.empty((n_workers, c), device=device, dtype=torch.float32)
    if n_workers * c == 0:
        return q
    # h1..h4 return to the caching allocator while the launches may still
    # run: safe, because the allocator reuses a block only in stream order
    hidden = [torch.empty((n_workers, c, w.shape[2]), device=device,
                          dtype=torch.float32) for w, _ in weights[:-1]]
    lib = build.load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = getattr(lib, fn_name)(
            *a_ptrs, *[t.data_ptr() for wb in weights for t in wb],
            *[h.data_ptr() for h in hidden], q.data_ptr(),
            n_workers, c, k_arg, *[h.shape[2] for h in hidden], stream)
    if err != 0:
        raise RuntimeError(f"{fn_name} failed: CUDA error {err} "
                           f"({lib.packed_qnet_error_string(err).decode()})")
    return q


def packed_qnet_stacked(weights: Weights, bits: torch.Tensor,
                        frac: torch.Tensor) -> torch.Tensor:
    """weights ``[(w [W, in, out], b [W, out])] x 5``, bits u8 ``[W, C, n_bytes]``
    (MSB-first planes), frac f32 ``[W, C]`` -> q ``[W, C]``; in = 8 n_bytes + 1."""
    if _device(bits) == "cpu":
        return packed_qnet_stacked_ref(bits, frac, weights)
    weights = pad_to_kernel_depth(weights)
    _check_rows(bits, "bits", torch.uint8, 3)
    _check_rows(frac, "frac", torch.float32, 2)
    n_workers, c, n_bytes = bits.shape
    if tuple(frac.shape) != (n_workers, c) or frac.device != bits.device:
        raise ValueError(f"frac {tuple(frac.shape)} on {frac.device} does not "
                         f"match bits {tuple(bits.shape)} on {bits.device}")
    _check_weights(weights, n_workers, 8 * n_bytes + 1, bits.device)
    q = _launch("packed_qnet_stacked_forward", [bits.data_ptr(), frac.data_ptr()],
                weights, n_workers, c, n_bytes, bits.device)
    packed_qnet_stacked.launches += 1
    return q


def packed_qnet(weights: Weights, bits: torch.Tensor,
                frac: torch.Tensor) -> torch.Tensor:
    """weights ``[(w [in, out], b [out])] x 5`` (one parameter set), bits u8
    ``[N, n_bytes]`` (MSB-first planes), frac f32 ``[N]`` -> q ``[N]``: the
    packed kernel launched with one worker."""
    if _device(bits) == "cpu":
        return packed_qnet_ref(bits, frac, weights)
    _check_rows(bits, "bits", torch.uint8, 2)
    _check_rows(frac, "frac", torch.float32, 1)
    n, n_bytes = bits.shape
    if tuple(frac.shape) != (n,) or frac.device != bits.device:
        raise ValueError(f"frac {tuple(frac.shape)} on {frac.device} does not "
                         f"match bits {tuple(bits.shape)} on {bits.device}")
    stacked = pad_to_kernel_depth([(w.unsqueeze(0), b.unsqueeze(0))
                                   for w, b in weights])
    _check_weights(stacked, 1, 8 * n_bytes + 1, bits.device)
    q = _launch("packed_qnet_stacked_forward", [bits.data_ptr(), frac.data_ptr()],
                stacked, 1, n, n_bytes, bits.device)
    packed_qnet.launches += 1
    return q[0]


def dense_qnet_stacked(weights: Weights, x: torch.Tensor) -> torch.Tensor:
    """weights as above, x f32 ``[W, C, in]`` -> q ``[W, C]``: the same
    kernel with its dense row loader."""
    if _device(x) == "cpu":
        return stacked_qnet_ref(x, weights)
    weights = pad_to_kernel_depth(weights)
    _check_rows(x, "x", torch.float32, 3)
    n_workers, c, width = x.shape
    _check_weights(weights, n_workers, width, x.device)
    q = _launch("dense_qnet_stacked_forward", [x.data_ptr()], weights,
                n_workers, c, width, x.device)
    dense_qnet_stacked.launches += 1
    return q


packed_qnet_stacked.launches = 0
packed_qnet.launches = 0
dense_qnet_stacked.launches = 0
