"""Hand-written CUDA kernels for Hopper (sm_90a), one per Pallas kernel of
``repro.kernels``; ``stacked_adam``, the learner's fused Adam over its
stacked workers; and ``leaf_adam``, the LM train step's fused, in-place Adam
over its leaves (the reference leaves both to XLA).

Each kernel ships as ``<name>/{csrc/<name>.cu, build.py, ops.py, ref.py}``:
the CUDA source; its ``nvcc`` build into ``build/repro_torch/`` at the
repository root, loaded with ``ctypes``; the wrapper that checks inputs,
launches on the current stream and counts launches; and the plain
PyTorch version the wrapper runs for CPU tensors.
"""

import torch


def refuse_grad(kernel: str, *inputs) -> None:
    """Raise if autograd would record ``kernel``: the LM kernels are forward
    only, as the reference's Pallas kernels are (no ``custom_vjp``), and a
    CUDA launch writes its outputs through raw pointers, so a gradient
    through it would be silently missing on the card.  Called first, on
    either device, so the CPU refuses what the card would get wrong."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        raise RuntimeError(
            f"{kernel} is forward only: the reference defines no gradient for "
            f"its kernel, so training runs with use_pallas=False (run a "
            f"use_pallas forward under torch.no_grad())")
