"""Hopper counterpart of ``repro.kernels.fused_qnet``."""

from repro_torch.kernels.fused_qnet.ops import fused_qnet

__all__ = ["fused_qnet"]
