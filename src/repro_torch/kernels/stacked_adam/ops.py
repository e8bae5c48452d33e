"""``stacked_adam``: one fused Adam step of many workers' parameters,
stacked ``[W, ...]`` leaf by leaf, in place.

On CUDA tensors it launches the hand-written kernel
(``csrc/stacked_adam.cu``) on the current stream, or raises; on CPU
tensors it runs the plain version (``ref.stacked_adam_ref``), as every
kernel of the port does.  ``lr``, ``b1``, ``b2``, ``eps`` and ``clip`` go
to the kernel as arguments, so a step copies nothing from the host.
``stacked_adam.launches`` counts the kernel's calls.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from repro_torch.kernels.stacked_adam import build
from repro_torch.kernels.stacked_adam.ref import stacked_adam_ref

MAX_LEAVES = 16       # csrc/stacked_adam.cu's kMaxLeaves
MAX_ROWS = 65535      # the grid's y dimension


def _grad_row_stride(g: torch.Tensor, p: torch.Tensor) -> int:
    """``g``'s row stride in elements: a row's size when ``g`` is laid out
    as ``p``, 0 when every row is one contiguous gradient."""
    if g.is_contiguous():
        return p[0].numel()
    if g.stride(0) == 0 and g[0].is_contiguous():
        return 0
    raise ValueError("a gradient must be contiguous [W, ...] or one "
                     "contiguous row expanded over W (row stride 0)")


def _check(params, grads, mu, nu, step) -> None:
    dev = step.device
    n = step.shape[0]
    if step.dtype != torch.int32 or step.dim() != 1 or not step.is_contiguous():
        raise ValueError(f"step must be contiguous int32 [W], got "
                         f"{step.dtype} {tuple(step.shape)}")
    if not 0 < len(params) <= MAX_LEAVES:
        raise ValueError(f"stacked_adam takes 1 to {MAX_LEAVES} leaves, got "
                         f"{len(params)}")
    if not len(params) == len(grads) == len(mu) == len(nu):
        raise ValueError("params, grads, mu and nu need one tensor per leaf")
    if n > MAX_ROWS:
        raise ValueError(f"stacked_adam takes at most {MAX_ROWS} rows, got {n}")
    for k, (p, g, m, v) in enumerate(zip(params, grads, mu, nu)):
        for name, t in (("p", p), ("g", g), ("mu", m), ("nu", v)):
            if t.device != dev or t.dtype != torch.float32:
                raise ValueError(f"leaf {k} {name}: need float32 on {dev}, "
                                 f"got {t.dtype} on {t.device}")
            if tuple(t.shape) != tuple(p.shape) or p.shape[0] != n:
                raise ValueError(f"leaf {k} {name}: shape {tuple(t.shape)}, "
                                 f"want [{n}, ...] as p {tuple(p.shape)}")
        for name, t in (("p", p), ("mu", m), ("nu", v)):
            if not t.is_contiguous():
                raise ValueError(f"leaf {k} {name} must be contiguous")


def stacked_adam(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                 mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                 step: torch.Tensor, *, lr: float, clip: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> None:
    """One Adam step of each row ``w`` of the leaves ``params [W, ...]`` on
    ``grads``, with ``optim/adam.py``'s clip (``clip`` is its
    ``clip_norm``), formulas and defaults: ``step [W]`` int32 += 1, then
    ``mu``, ``nu`` and ``params`` are written in place.  A gradient may be
    one row expanded over ``W`` (row stride 0)."""
    if step.device.type == "cpu":
        return stacked_adam_ref(params, grads, mu, nu, step, lr=lr, b1=b1,
                                b2=b2, eps=eps, clip=clip)
    if step.device.type != "cuda":
        raise ValueError(f"stacked_adam runs on cuda or cpu, got {step.device}")
    _check(params, grads, mu, nu, step)
    n = step.shape[0]
    if n == 0:
        return
    lib = build.load()
    info = np.array([[p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
                      p[0].numel(), _grad_row_stride(g, p)]
                     for p, g, m, v in zip(params, grads, mu, nu)], np.int64)
    tile = lib.stacked_adam_tile()
    tiles = int(sum(-(-int(p[0].numel()) // tile) for p in params))
    dev = step.device
    # the scratch goes back to the caching allocator on return while the
    # launches may still run: safe, the allocator hands a block out again
    # only in stream order on the same stream
    partials = torch.empty(n * max(tiles, 1), dtype=torch.float64, device=dev)
    rows = torch.empty((n, 3), dtype=torch.float32, device=dev)
    f32 = lambda x: float(np.float32(x))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.stacked_adam_step(
            info.ctypes.data, len(params), n, step.data_ptr(),
            partials.data_ptr(), rows.data_ptr(), f32(-lr), f32(b1),
            f32(1 - b1), f32(b2), f32(1 - b2), f32(eps), f32(clip), stream)
    if err != 0:
        raise RuntimeError(f"stacked_adam launch failed: CUDA error {err} "
                           f"({lib.stacked_adam_error_string(err).decode()})")
    stacked_adam.launches += 1


stacked_adam.launches = 0
