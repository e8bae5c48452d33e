"""A fused Adam step over the trainer's stacked per-worker parameters."""

from repro_torch.kernels.stacked_adam.ops import stacked_adam

__all__ = ["stacked_adam"]
