"""The port's LM kernels' plain versions against the JAX reference's Pallas
kernels, on the CPU.

Inputs are made with numpy from a seed and handed to both packages (bf16
inputs cross as the same bits).  The reference runs ``flash_attention`` and
``ssd_scan`` in Pallas interpret mode; the port's wrappers, given CPU
tensors, run their plain versions (``attention_ref``; ``ssd_ref``, the
naive recurrence) and launch nothing.  Tolerances are the ones
``tests/test_kernels.py`` holds the Pallas kernels to against their
oracles: flash 2e-5 in f32 and 2e-2 in bf16, ssd 2e-4 in f32 and 5e-2 in
bf16.  The CUDA kernels themselves are held to the same tolerances on the
card by ``chip_smoke.py``.  Also: ``packed_qnet`` (the W = 1 launch of the
packed kernel) against the reference's Pallas ``packed_qnet_rows``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.agent import QNetwork as JaxQNetwork
from repro.kernels.flash_attention.ops import flash_attention as jax_flash
from repro.kernels.packed_qnet.ops import packed_qnet as jax_packed_qnet
from repro.kernels.ssd_scan.ops import ssd_scan as jax_ssd
from repro_torch.core import agent
from repro_torch.kernels.flash_attention import build as fa_build
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.kernels.packed_qnet import ops as pq_ops
from repro_torch.kernels.ssd_scan import build as ss_build
from repro_torch.kernels.ssd_scan import ops as ss_ops
from repro_torch.models.ssm import ssd_chunked

FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
SSD_TOL = {"float32": 2e-4, "bfloat16": 5e-2}


def _both(a: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor of ``dtype``."""
    j = jnp.asarray(a, getattr(jnp, dtype))
    n = np.asarray(j)
    if dtype == "bfloat16":
        t = torch.from_numpy(n.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(n.copy())
    return j, t


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


def _flash_inputs(B, S, H, K, D, dtype, seed):
    rng = np.random.default_rng(seed)
    return [_both(rng.standard_normal((B, S, n, D)).astype(np.float32), dtype)
            for n in (H, K, K)]


@pytest.mark.parametrize("B,S,H,K,D", [
    (2, 256, 4, 2, 64),
    (1, 128, 4, 4, 128),
    (2, 256, 8, 1, 64),      # MQA
    (1, 512, 2, 2, 32),
    (1, 128, 14, 2, 128),    # GQA ratio 7 (yi-34b)
    (1, 128, 32, 2, 64),     # GQA ratio 16 (qwen3-moe-235b-a22b)
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_plain_matches_pallas(B, S, H, K, D, dtype):
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(B, S, H, K, D, dtype, S + D)
    want = jax_flash(jq, jk, jv, causal=True, interpret=True)
    launches = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(tq, tk, tv, causal=True)
    assert fa_ops.flash_attention.launches == launches   # no kernel on the CPU
    assert got.shape == (B, S, H, D) and got.dtype == tq.dtype
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


@pytest.mark.parametrize("window,prefix,causal", [
    (64, 0, True), (None, 32, True), (32, 16, True), (None, 0, False),
])
def test_flash_attention_masks_match_pallas(window, prefix, causal):
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(1, 256, 4, 2, 64, "float32", 7)
    want = jax_flash(jq, jk, jv, causal=causal, window=window,
                     prefix_len=prefix, interpret=True)
    got = fa_ops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                 prefix_len=prefix)
    np.testing.assert_allclose(_f32(got), _f32(want), atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("B,S,H,K,window,prefix", [
    (1, 128, 4, 1, None, 16),     # MQA with paligemma's image prefix
    (2, 96, 2, 1, 32, 0),         # MQA with a window
    (1, 128, 4, 2, 48, 16),       # GQA, window and prefix
])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_attention_head_dim_256_matches_pallas(B, S, H, K, window, prefix, dtype):
    """paligemma-3b's head dim: the Pallas kernel takes D <= 256, and so does
    the port's wrapper (the CUDA kernel re-reads q's fragments from shared
    memory there; its plain version here)."""
    assert 256 in fa_ops.HEAD_DIMS
    (jq, tq), (jk, tk), (jv, tv) = _flash_inputs(B, S, H, K, 256, dtype, S + H)
    mk = dict(causal=True, window=window, prefix_len=prefix)
    want = jax_flash(jq, jk, jv, interpret=True, **mk)
    launches = fa_ops.flash_attention.launches
    got = fa_ops.flash_attention(tq, tk, tv, **mk)
    assert fa_ops.flash_attention.launches == launches
    assert got.shape == (B, S, H, 256) and got.dtype == tq.dtype
    tol = FLASH_TOL[dtype]
    np.testing.assert_allclose(_f32(got), _f32(want), atol=tol, rtol=tol)


def test_flash_attention_matches_the_models_plain_route():
    """``gqa_attention``'s blocked plain route and the kernel route agree,
    as ``tests/test_kernels.py`` holds the reference's (3e-5)."""
    from repro_torch.models.layers import gqa_attention
    (_, tq), (_, tk), (_, tv) = _flash_inputs(1, 256, 4, 2, 64, "float32", 8)
    a = gqa_attention(tq, tk, tv, causal=True, q_block=128)
    b = gqa_attention(tq, tk, tv, causal=True, use_pallas=True)
    np.testing.assert_allclose(a.numpy(), b.numpy(), atol=3e-5, rtol=3e-5)


def _ssd_inputs(B, L, H, P, G, N, dtype, seed, dt_dtype="float32"):
    rng = np.random.default_rng(seed)
    x = _both((rng.standard_normal((B, L, H, P)) * 0.5).astype(np.float32), dtype)
    dt = _both((np.abs(rng.standard_normal((B, L, H))) * 0.1 + 0.01)
               .astype(np.float32), dt_dtype)
    A = _both((np.abs(rng.standard_normal(H)) + 0.5).astype(np.float32), "float32")
    Bm = _both((rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32), dtype)
    Cm = _both((rng.standard_normal((B, L, G, N)) * 0.3).astype(np.float32), dtype)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("B,L,H,P,G,N,chunk", [
    (2, 256, 4, 32, 1, 16, 64),
    (1, 128, 2, 64, 2, 32, 128),
    (2, 512, 8, 16, 1, 8, 128),
    (1, 64, 4, 16, 4, 64, 32),
    # mamba2-2.7b's N = 128, one and two groups, short and long chunks
    (1, 64, 2, 16, 1, 128, 16),
    (1, 128, 2, 16, 1, 128, 64),
    (1, 64, 4, 16, 2, 128, 16),
    (1, 128, 4, 16, 2, 128, 64),
    # chunks the kernel cuts into a ragged last 64-row tile, or many tiles
    (1, 192, 4, 16, 1, 16, 96),
    (1, 512, 4, 16, 1, 16, 512),
])
def test_ssd_scan_plain_matches_pallas(B, L, H, P, G, N, chunk):
    ins = _ssd_inputs(B, L, H, P, G, N, "float32", L + P + N)
    y, s = jax_ssd(*[j for j, _ in ins], chunk=chunk, interpret=True)
    launches = ss_ops.ssd_scan.launches
    ty, ts = ss_ops.ssd_scan(*[t for _, t in ins], chunk=chunk)
    assert ss_ops.ssd_scan.launches == launches          # no kernel on the CPU
    assert ty.shape == (B, L, H, P) and ts.shape == (B, H, P, N)
    np.testing.assert_allclose(ty.numpy(), np.asarray(y), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(ts.numpy(), np.asarray(s), atol=2e-4, rtol=2e-4)


def test_ssd_scan_bf16_matches_pallas():
    """bf16 x, dt, B and C, f32 A: ``tests/test_kernels.py``'s bf16 case."""
    ins = _ssd_inputs(1, 128, 2, 32, 1, 16, "bfloat16", 5, dt_dtype="bfloat16")
    y, _ = jax_ssd(*[j for j, _ in ins], chunk=64, interpret=True)
    ty, _ = ss_ops.ssd_scan(*[t for _, t in ins], chunk=64)
    assert ty.dtype == torch.bfloat16
    np.testing.assert_allclose(_f32(ty), _f32(y), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("chunk", [16, 64])
def test_ssd_scan_plain_matches_the_ports_ssd_chunked(chunk):
    """The recurrence and the port's chunked algorithm agree, and the
    chunked final state equals a step-by-step decode's."""
    from repro_torch.models.ssm import ssd_decode_step
    _, ins = zip(*_ssd_inputs(2, 64, 4, 16, 2, 16, "float32", 11))
    y, s = ss_ops.ssd_scan(*ins, chunk=chunk)
    yc, sc = ssd_chunked(*ins, chunk=chunk)
    np.testing.assert_allclose(yc.numpy(), y.numpy(), atol=2e-4, rtol=2e-4)
    np.testing.assert_allclose(sc.numpy(), s.numpy(), atol=2e-4, rtol=2e-4)
    x, dt, A, Bm, Cm = ins
    st = torch.zeros(2, 4, 16, 16)
    for t in range(x.shape[1]):
        _, st = ssd_decode_step(st, x[:, t], dt[:, t], A, Bm[:, t], Cm[:, t])
    np.testing.assert_allclose(st.numpy(), sc.numpy(), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("case", [
    "head_dim_48", "head_dim_512", "heads_not_divisible", "float16",
    "mixed_types", "window_0", "empty_keys"])
def test_flash_attention_raises_on_what_the_kernel_does_not_take(case):
    q = torch.zeros(1, 8, 4, 64)
    k = v = torch.zeros(1, 8, 2, 64)
    kw = {}
    if case in ("head_dim_48", "head_dim_512"):
        D = int(case.split("_")[-1])
        q, k, v = torch.zeros(1, 8, 4, D), torch.zeros(1, 8, 2, D), torch.zeros(1, 8, 2, D)
    elif case == "heads_not_divisible":
        k = v = torch.zeros(1, 8, 3, 64)
    elif case == "float16":
        q, k, v = (t.half() for t in (q, k, v))
    elif case == "mixed_types":
        q = q.bfloat16()
    elif case == "window_0":
        kw = {"window": 0}
    else:
        k = v = torch.zeros(1, 0, 2, 64)
    with pytest.raises(ValueError):
        fa_ops.flash_attention(q, k, v, **kw)


@pytest.mark.parametrize("case", [
    "state_dim_256", "head_dim_128", "chunk_not_dividing",
    "heads_not_divisible", "mixed_types"])
def test_ssd_scan_raises_on_what_the_kernel_does_not_take(case):
    B, L, H, P, G, N, chunk = 1, 64, 4, 16, 1, 16, 32
    if case == "state_dim_256":
        N = 256                      # past every config's N (ROADMAP C)
    elif case == "head_dim_128":
        P = 128
    elif case == "chunk_not_dividing":
        chunk = 48
    elif case == "heads_not_divisible":
        G = 3
    x, dt, A = torch.zeros(B, L, H, P), torch.zeros(B, L, H), torch.zeros(H)
    Bm, Cm = torch.zeros(B, L, G, N), torch.zeros(B, L, G, N)
    if case == "mixed_types":
        Bm = Bm.bfloat16()
    with pytest.raises(ValueError):
        ss_ops.ssd_scan(x, dt, A, Bm, Cm, chunk=chunk)


@pytest.mark.parametrize("build,name", [(fa_build, "flash_attention.cu"),
                                        (ss_build, "ssd_scan.cu")])
def test_build_names_its_source(build, name):
    """Each build compiles its own CUDA source (nothing is built here: the
    library's name hashes the source and its flags)."""
    b = build.nvcc_build()
    assert b.source == build.SOURCE and b.source.name == name
    assert b.source.is_file()
    assert b.library.name.startswith(f"lib{b.source.stem}-")
    assert "Replaces the TPU kernel" in b.source.read_text()


@pytest.mark.parametrize("n", [1, 5, 128, 300])
def test_packed_qnet_plain_matches_pallas(n):
    """The port's ``packed_qnet`` on CPU tensors (plain: unpack, then the
    MLP) against the reference's Pallas bit-plane kernel in interpret mode,
    under one full-width parameter set, <= 1e-5."""
    params = jax.tree_util.tree_map(
        np.asarray, JaxQNetwork().init(jax.random.PRNGKey(3)))
    rng = np.random.default_rng(n)
    bits = rng.integers(0, 256, size=(n, 256), dtype=np.uint8)
    frac = rng.random(n).astype(np.float32)
    want = np.asarray(jax_packed_qnet(params, jnp.asarray(bits), jnp.asarray(frac),
                                      impl="pallas", interpret=True))
    net = agent.params_from_jax(params, device="cpu")
    launches = pq_ops.packed_qnet.launches
    got = pq_ops.packed_qnet(net.layers(), torch.from_numpy(bits),
                             torch.from_numpy(frac))
    assert pq_ops.packed_qnet.launches == launches
    assert got.shape == (n,)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)
