"""Device policy of the port: the GPU unless the caller names another.

``resolve_device(None)`` is ``cuda``; there is no silent fallback to the
CPU.  Tests pass ``device="cpu"`` explicitly, and then every kernel
wrapper runs its plain PyTorch version.  TF32 is switched off for
matmuls and convolutions, so float32 means float32 on the card too.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """``None`` -> ``cuda``.  Raises if CUDA is asked for and absent."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on the GPU by default, and torch sees no CUDA "
            "device here; pass device='cpu' to run the plain PyTorch path")
    return dev
