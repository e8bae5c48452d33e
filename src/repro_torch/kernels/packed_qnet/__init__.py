"""Hopper counterpart of ``repro.kernels.packed_qnet``: the stacked kernel,
its one-parameter-set launch, and the plain versions it exports."""

from repro_torch.kernels.packed_qnet.ops import (dense_qnet_stacked,
                                                 packed_qnet,
                                                 packed_qnet_stacked)
from repro_torch.kernels.packed_qnet.ref import pack_w1, packed_qnet_ref

__all__ = ["dense_qnet_stacked", "pack_w1", "packed_qnet", "packed_qnet_ref",
           "packed_qnet_stacked"]
