"""Port of ``repro.kernels.flash_attention.ops``: ``flash_attention``,
blocked online-softmax GQA attention with causal, sliding-window and
prefix-LM masks, in the model layout ``[B, S, H, D]``.

On a CUDA tensor it launches the hand-written kernel
(``csrc/flash_attention.cu``) on the current stream, or raises; on a CPU
tensor it runs the plain version (``ref.attention_ref``).  Forward only, as
the reference's Pallas kernel, which has no ``custom_vjp``: with grad
enabled and an input that requires grad it raises on either device before
any launch (``refuse_grad``), so training runs with ``use_pallas=False``.  The kernel reads
q, k and v by strides, so there are no transposes on the card.  Inputs the
kernel does not take raise on either device.  ``flash_attention.launches``
counts the kernel launches, so a run can show that its attention went
through it.  The bf16 kernel copies rows with 16-byte ``cp.async``, so a
CUDA bf16 tensor's data pointer and its batch, sequence and head strides
must be 16-byte multiples (the model's contiguous projections meet
this).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.flash_attention import build
from repro_torch.kernels.flash_attention.ref import attention_ref

HEAD_DIMS = (32, 64, 128, 256)   # 256: paligemma-3b
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           window: int | None, prefix_len: int) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"need q [B, Sq, H, D] and k, v [B, Sk, K, D], got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    B, Sq, H, D = q.shape
    if k.shape[0] != B or k.shape[3] != D or Sq == 0 or k.shape[1] == 0:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"share batch and head dim, or a length is 0")
    if k.shape[2] == 0 or H % k.shape[2]:
        raise ValueError(f"{H} query heads do not split over {k.shape[2]} kv heads")
    if D not in HEAD_DIMS:
        raise ValueError(f"the kernel takes head dims {HEAD_DIMS}, got {D}")
    if q.dtype not in DTYPES or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must share one of {list(DTYPES)}, got "
                         f"{q.dtype}, {k.dtype}, {v.dtype}")
    if k.device != q.device or v.device != q.device:
        raise ValueError(f"q, k, v on {q.device}, {k.device}, {v.device}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError("the head dim of q, k and v must be contiguous")
    if window is not None and window < 1:
        raise ValueError(f"window must be >= 1 or None, got {window}")
    if prefix_len < 0:
        raise ValueError(f"prefix_len must be >= 0, got {prefix_len}")
    if q.device.type == "cuda" and q.dtype == torch.bfloat16:
        for name, t in (("q", q), ("k", k), ("v", v)):
            if t.data_ptr() % 16 or any(t.stride(i) % 8 for i in range(3)
                                        if t.shape[i] > 1):
                raise ValueError(
                    f"bf16 {name} on the card needs a 16-byte aligned data "
                    f"pointer and batch, sequence and head strides in "
                    f"multiples of 8 elements, got pointer {t.data_ptr()} "
                    f"and strides {t.stride()}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None,
                    prefix_len: int = 0) -> torch.Tensor:
    """q ``[B, Sq, H, D]``, k and v ``[B, Sk, K, D]`` -> ``[B, Sq, H, D]`` in
    q's type, scale ``D^-0.5``, kv head ``h // (H // K)``."""
    refuse_grad("flash_attention", q, k, v)
    _check(q, k, v, window, prefix_len)
    if q.device.type == "cpu":
        return attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             prefix_len=prefix_len).transpose(1, 2)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cuda or cpu, got {q.device}")
    B, Sq, H, D = q.shape
    Sk, K = k.shape[1], k.shape[2]
    o = torch.empty((B, Sq, H, D), device=q.device, dtype=q.dtype)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = lib.flash_attention_forward(
            DTYPES[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            o.data_ptr(), B, H, K, Sq, Sk, *q.stride()[:3], *k.stride()[:3],
            *v.stride()[:3], *o.stride()[:3], D ** -0.5, int(causal),
            window or 0, prefix_len, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {err} "
                           f"({lib.flash_attention_error_string(err).decode()})")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
