"""A fused, in-place Adam step over the leaves of an LM's parameter tree."""

from repro_torch.kernels.leaf_adam.ops import leaf_adam

__all__ = ["leaf_adam"]
