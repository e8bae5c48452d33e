"""Port of ``repro.kernels.ssd_scan.ops``: ``ssd_scan``, the Mamba2 SSD
chunked scan, ``(y, final_state)``.

On a CUDA tensor it launches the hand-written kernel (``csrc/ssd_scan.cu``:
chunk summaries, a pass over chunk states, then the chunks' outputs, three
launches) on the current stream, or raises; on a CPU tensor it runs the
plain version (``ref.ssd_ref``, the definitional recurrence).  Forward
only, as the reference's Pallas kernel, which has no ``custom_vjp``: with
grad enabled and an input that requires grad it raises on either device
before any launch (``refuse_grad``), so training runs with
``use_pallas=False``.  The kernel
reads x, B and C by strides, so the model's views into its conv output go
in as they are; dt and A go in as f32 (a bf16 dt is widened, exactly).
Inputs the kernel does not take raise on either device.
``ssd_scan.launches`` counts the wrapper's calls that launched the kernel,
so a run can show that its SSM layers went through it.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import refuse_grad
from repro_torch.kernels.ssd_scan import build
from repro_torch.kernels.ssd_scan.ref import ssd_ref

DTYPES = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 64        # P: the [16, P] accumulators of a warp
MAX_STATE_DIM = 128      # N: C's fragments of a warp stay in registers


def _check(x, dt, A, B_, C_, chunk: int) -> int:
    """The chunk length the kernel will use (``min(chunk, L)``, as the
    reference's kernel takes it); raises on what the kernel does not take."""
    if x.dim() != 4 or dt.dim() != 3 or A.dim() != 1 or B_.dim() != 4 \
            or B_.shape != C_.shape:
        raise ValueError(f"need x [B, L, H, P], dt [B, L, H], A [H], B/C "
                         f"[B, L, G, N], got {tuple(x.shape)}, {tuple(dt.shape)}, "
                         f"{tuple(A.shape)}, {tuple(B_.shape)}, {tuple(C_.shape)}")
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    if tuple(dt.shape) != (Bb, L, H) or tuple(A.shape) != (H,) \
            or tuple(B_.shape[:2]) != (Bb, L):
        raise ValueError(f"x {tuple(x.shape)}, dt {tuple(dt.shape)}, A "
                         f"{tuple(A.shape)}, B {tuple(B_.shape)} disagree")
    if Bb == 0 or L == 0 or H == 0 or G == 0 or H % G:
        raise ValueError(f"{H} heads over {G} groups, batch {Bb}, length {L}")
    if not 0 < P <= MAX_HEAD_DIM or not 0 < N <= MAX_STATE_DIM:
        raise ValueError(f"the kernel takes P <= {MAX_HEAD_DIM} and N <= "
                         f"{MAX_STATE_DIM}, got P={P}, N={N}")
    if x.dtype not in DTYPES or B_.dtype != x.dtype or C_.dtype != x.dtype:
        raise ValueError(f"x, B, C must share one of {list(DTYPES)}, got "
                         f"{x.dtype}, {B_.dtype}, {C_.dtype}")
    if dt.dtype not in DTYPES or A.dtype not in DTYPES:
        raise ValueError(f"dt and A must be float32 or bfloat16, got "
                         f"{dt.dtype}, {A.dtype}")
    if any(t.device != x.device for t in (dt, A, B_, C_)):
        raise ValueError("x, dt, A, B and C must share one device")
    if any(t.stride(-1) != 1 for t in (x, B_, C_)):
        raise ValueError("the last dim of x, B and C must be contiguous")
    q = min(chunk, L)
    if q <= 0 or L % q:
        raise ValueError(f"chunk {q} must divide L={L}")
    return q


def ssd_scan(x: torch.Tensor, dt: torch.Tensor, A: torch.Tensor,
             B_: torch.Tensor, C_: torch.Tensor, *,
             chunk: int = 128) -> tuple[torch.Tensor, torch.Tensor]:
    """x ``[B, L, H, P]``, dt ``[B, L, H]``, A ``[H]``, B/C ``[B, L, G, N]``
    -> (y ``[B, L, H, P]``, final state ``[B, H, P, N]``), both in x's type."""
    refuse_grad("ssd_scan", x, dt, A, B_, C_)
    q = _check(x, dt, A, B_, C_, chunk)
    if x.device.type == "cpu":
        return ssd_ref(x, dt, A, B_, C_)
    if x.device.type != "cuda":
        raise ValueError(f"ssd_scan runs on cuda or cpu, got {x.device}")
    Bb, L, H, P = x.shape
    G, N = B_.shape[2], B_.shape[3]
    dt32 = dt.float()
    a32 = A.float().contiguous()
    y = torch.empty((Bb, L, H, P), device=x.device, dtype=x.dtype)
    final = torch.empty((Bb, H, P, N), device=x.device, dtype=x.dtype)
    cum = torch.empty((Bb, H, L), device=x.device, dtype=torch.float32)
    states = torch.empty((Bb, H, L // q, P, N), device=x.device,
                         dtype=torch.float32)
    # bf16: the entering states as hi and lo bf16 planes, N padded to 16
    hl = torch.empty((Bb, H, L // q, 2, P, -(-N // 16) * 16), device=x.device,
                     dtype=torch.bfloat16) if x.dtype == torch.bfloat16 else None
    lib = build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.ssd_scan_forward(
            DTYPES[x.dtype], x.data_ptr(), dt32.data_ptr(), a32.data_ptr(),
            B_.data_ptr(), C_.data_ptr(), y.data_ptr(), final.data_ptr(),
            cum.data_ptr(), states.data_ptr(),
            None if hl is None else hl.data_ptr(), Bb, L, H, G, P, N, q,
            *x.stride()[:3], *dt32.stride(), *B_.stride()[:3],
            *C_.stride()[:3], stream)
    if err != 0:
        raise RuntimeError(f"ssd_scan launch failed: CUDA error {err} "
                           f"({lib.ssd_scan_error_string(err).decode()})")
    ssd_scan.launches += 1
    return y, final


ssd_scan.launches = 0
