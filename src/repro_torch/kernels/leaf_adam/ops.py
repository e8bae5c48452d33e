"""``leaf_adam``: one fused Adam step over a list of leaves, in place:
``optim/adam.py``'s ``update`` followed by ``apply_updates``, with the
global-norm clip.

On CUDA leaves it launches the hand-written kernel (``csrc/leaf_adam.cu``)
on the current stream, or raises; on any other device it runs the plain
version (``ref.leaf_adam_ref``, with ``optim/adam.py``'s own norm), as
every kernel of the port does.  ``lr_t``, ``bc1`` and ``bc2`` are f32
scalars on the leaves' device, read by the kernel there, so a step copies
nothing between host and device.  ``leaf_adam.launches`` counts the
kernel's calls.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.leaf_adam import build
from repro_torch.kernels.leaf_adam.ref import leaf_adam_ref

DTYPES = (torch.bfloat16, torch.float32)     # a leaf's parameter and gradient


def _check(params, grads, mu, nu, scalars) -> None:
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError("params, grads, mu and nu need one tensor per leaf")
    dev = params[0].device
    for name, t in zip(("lr_t", "bc1", "bc2"), scalars):
        if t.device != dev or t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"{name} must be one float32 on {dev}, got "
                             f"{t.dtype} {tuple(t.shape)} on {t.device}")
    for k, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        if p.dtype not in DTYPES or g.dtype != p.dtype:
            raise ValueError(f"leaf {k}: the parameter and its gradient must be "
                             f"both bfloat16 or both float32, got {p.dtype} and "
                             f"{g.dtype}")
        for name, t in (("p", p), ("g", g), ("mu", m), ("nu", v)):
            if t.device != dev:
                raise ValueError(f"leaf {k} {name} is on {t.device}, not {dev}")
            if tuple(t.shape) != tuple(p.shape):
                raise ValueError(f"leaf {k} {name}: shape {tuple(t.shape)}, want "
                                 f"{tuple(p.shape)}")
            if not t.is_contiguous():
                raise ValueError(f"leaf {k} {name} must be contiguous")
        if m.dtype != torch.float32 or v.dtype != torch.float32:
            raise ValueError(f"leaf {k}: the moments must be float32, got "
                             f"{m.dtype} and {v.dtype}")


def leaf_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
              mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], *,
              lr_t: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
              b1: float, b2: float, eps: float, clip: float | None,
              weight_decay: float = 0.0) -> None:
    """One Adam step of every leaf, in place: ``mu``, ``nu`` and ``params``
    take ``optim/adam.py``'s values after ``update`` and ``apply_updates``
    (the step's count, ``lr_t`` and the bias corrections ``bc1``, ``bc2``
    computed by the caller as ``update`` computes them); ``clip`` is its
    ``clip_norm`` (None: no clip).  Parameters and gradients bf16 or f32,
    one type a leaf; moments f32; every tensor contiguous."""
    if not params:
        return
    if params[0].device.type != "cuda":
        return leaf_adam_ref(params, grads, mu, nu, lr_t=lr_t, bc1=bc1, bc2=bc2,
                             b1=b1, b2=b2, eps=eps, clip=clip,
                             weight_decay=weight_decay)
    _check(params, grads, mu, nu, (lr_t, bc1, bc2))
    lib = build.load()
    info = np.array([[p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                      p.numel(), int(p.dtype == torch.bfloat16)]
                     for p, g, m, v in zip(params, grads, mu, nu)],
                    np.int64).reshape(-1, 6)
    dev = lr_t.device
    tables = -(-len(params) // lib.leaf_adam_max_leaves())
    # the scratch goes back to the caching allocator on return while the
    # launches may still run: safe, the allocator hands a block out again
    # only in stream order on the same stream
    partials = torch.empty(max(tables, 1) * lib.leaf_adam_blocks(),
                           dtype=torch.float64, device=dev)
    scale = torch.empty((), dtype=torch.float32, device=dev)
    f32 = lambda x: float(np.float32(x))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.leaf_adam_step(
            info.ctypes.data, len(params), partials.data_ptr(), scale.data_ptr(),
            lr_t.data_ptr(), bc1.data_ptr(), bc2.data_ptr(), f32(b1), f32(1 - b1),
            f32(b2), f32(1 - b2), f32(eps), f32(weight_decay),
            int(bool(weight_decay)), f32(1.0 if clip is None else clip),
            int(clip is not None), stream)
    if err != 0:
        raise RuntimeError(f"leaf_adam launch failed: CUDA error {err} "
                           f"({lib.leaf_adam_error_string(err).decode()})")
    leaf_adam.launches += 1


leaf_adam.launches = 0
