"""The CUDA ``ssd_scan``'s three-stage decomposition, in plain PyTorch
(``kernels/ssd_scan/ref.py::ssd_stages``: chunk summaries, the pass over
chunk states, the chunks' outputs, with the bf16 route's rounding points),
against the definitional recurrence ``ssd_ref`` and the reference's Pallas
kernel in interpret mode, on the CPU.

Inputs are made with numpy from a seed and handed to both packages (bf16
inputs cross as the same bits).  Shapes run many chunks (nc >= 16), more
than one B/C group, and N in {16, 64, 128}.  Tolerances are the ones
``tests/test_kernels.py`` holds the Pallas kernel to: 2e-4 in f32 and 5e-2
in bf16 (abs + rel).  An error in the decomposition's algebra shows here
before the kernel reaches the card."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd
from repro_torch.kernels.ssd_scan.ref import _split_bf16, ssd_ref, ssd_stages

TOL = {"float32": 2e-4, "bfloat16": 5e-2}
SHAPES = [                      # B, L, H, P, G, N, chunk
    (1, 256, 4, 16, 2, 16, 16),
    (1, 256, 4, 16, 2, 64, 16),
    (1, 512, 4, 16, 2, 128, 32),
    (2, 1024, 2, 16, 1, 128, 64),
]


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    n = np.asarray(j)
    if dtype == "bfloat16":
        return j, torch.from_numpy(n.view(np.uint16).copy()).view(torch.bfloat16)
    return j, torch.from_numpy(n.copy())


def _inputs(B, L, H, P, G, N, dtype, seed):
    rng = np.random.default_rng(seed)
    x = _both((rng.standard_normal((B, L, H, P)) * 0.5).astype(np.float32), dtype)
    dt = _both((np.abs(rng.standard_normal((B, L, H))) * 0.1 + 0.01)
               .astype(np.float32), "float32")
    A = _both((np.abs(rng.standard_normal(H)) + 0.5).astype(np.float32), "float32")
    Bm = _both((rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32), dtype)
    Cm = _both((rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32), dtype)
    return x, dt, A, Bm, Cm


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), atol=tol, rtol=tol)


def _f32(t):
    return t.float().numpy() if isinstance(t, torch.Tensor) else np.asarray(
        t.astype(jnp.float32))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SHAPES)
def test_stages_match_the_recurrence(B, L, H, P, G, N, chunk, dtype):
    _, ins = zip(*_inputs(B, L, H, P, G, N, dtype, L + N + G))
    assert L // chunk >= 16
    y, s = ssd_stages(*ins, chunk=chunk)
    yr, sr = ssd_ref(*ins)
    assert y.dtype == s.dtype == ins[0].dtype
    assert y.shape == (B, L, H, P) and s.shape == (B, H, P, N)
    _close(_f32(y), _f32(yr), TOL[dtype])
    _close(_f32(s), _f32(sr), TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,L,H,P,G,N,chunk", SHAPES)
def test_stages_match_pallas(B, L, H, P, G, N, chunk, dtype):
    jins, tins = zip(*_inputs(B, L, H, P, G, N, dtype, 7 * L + N))
    yj, sj = jax_ssd(*jins, chunk=chunk, interpret=True)
    y, s = ssd_stages(*tins, chunk=chunk)
    _close(_f32(y), _f32(yj), TOL[dtype])
    _close(_f32(s), _f32(sj), TOL[dtype])


def test_bf16_split_keeps_sixteen_bits():
    """hi + lo carries an f32 value to 2^-16 of itself, where one bf16
    rounding keeps 2^-8: the carry-in and the summary do not compound a
    bf16 rounding of the state over chunks."""
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(4096)
                         .astype(np.float32) * 10.0)
    hi, lo = _split_bf16(v)
    assert hi.dtype == lo.dtype == torch.float32
    assert torch.equal(hi, v.to(torch.bfloat16).float())
    assert torch.equal(lo, lo.to(torch.bfloat16).float())
    rel = ((hi + lo - v).abs() / v.abs()).max().item()
    one = ((hi - v).abs() / v.abs()).max().item()
    assert rel <= 2.0 ** -16 < 2.0 ** -10 < one <= 2.0 ** -8
