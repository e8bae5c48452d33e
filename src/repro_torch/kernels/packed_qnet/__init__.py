"""Hopper counterpart of ``repro.kernels.packed_qnet``: the stacked kernel
and its one-parameter-set launch."""

from repro_torch.kernels.packed_qnet.ops import (dense_qnet_stacked,
                                                 packed_qnet,
                                                 packed_qnet_stacked)

__all__ = ["dense_qnet_stacked", "packed_qnet", "packed_qnet_stacked"]
