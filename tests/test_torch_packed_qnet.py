"""The port's stacked Q-network over packed fingerprint planes against the
JAX reference, on the CPU.

Inputs are packed planes and steps-left columns made with numpy from a
seed and handed to both packages; per-worker parameters are the
reference's own ``vmap(QNetwork.init)`` trees carried over as numpy.  The
reference runs its Pallas ``packed_qnet_stacked`` kernel in interpret mode,
which re-associates layer 1 into 8 bit-plane products; the port's plain
version sums the 2049 terms in its own order.  Both are float32, so Q
agrees to 1e-5 (abs and rel).  Unpacking is exact: every bit comes back
as the same 0.0 or 1.0."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.agent import QNetwork as JaxQNetwork
from repro.core.packed_batch import densify_batch as jax_densify
from repro.core.packed_batch import unpack_bits as jax_unpack
from repro.kernels.packed_qnet.ops import pack_w1 as jax_pack_w1
from repro.kernels.packed_qnet.ops import packed_qnet_stacked as jax_stacked
from repro_torch.core import agent
from repro_torch.core.packed_batch import (dense_nbytes_equivalent,
                                           densify_batch, packed_nbytes,
                                           unpack_bits)
from repro_torch.core.replay import densify_sample
from repro_torch.kernels import nvcc
from repro_torch.kernels.fused_qnet import build as fused_build
from repro_torch.kernels.packed_qnet import build, ops
from repro_torch.kernels.packed_qnet.ref import pack_w1

TOL = 1e-5
NARROW = (64, 32, 16, 8)


def _stacked_params(n_workers, hidden=None, seed=7):
    net = JaxQNetwork() if hidden is None else JaxQNetwork(hidden=hidden)
    keys = jax.random.split(jax.random.PRNGKey(seed), n_workers)
    return jax.tree_util.tree_map(np.asarray, jax.vmap(net.init)(keys))


def _planes(n_workers, c, seed, dead=()):
    rng = np.random.default_rng(seed)
    bits = (rng.integers(0, 256, (n_workers, c, 256))
            & rng.integers(0, 256, (n_workers, c, 256))).astype(np.uint8)
    frac = (rng.integers(0, 11, (n_workers, c)) / 10.0).astype(np.float32)
    for w in dead:                       # a dead worker: zero planes
        bits[w] = 0
        frac[w] = 0.0
    return bits, frac


@pytest.mark.parametrize("hidden,n_workers,c", [(None, 2, 20), (NARROW, 3, 9)],
                         ids=["full", "narrow"])
def test_plain_version_matches_the_pallas_kernel(hidden, n_workers, c):
    """Port plain ``packed_qnet_stacked`` (CPU tensors) against the
    reference's Pallas kernel in interpret mode, worker 1 dead."""
    params = _stacked_params(n_workers, hidden)
    bits, frac = _planes(n_workers, c, seed=c, dead=(1,))
    want = np.asarray(jax_stacked(params, jnp.asarray(bits), jnp.asarray(frac),
                                  impl="pallas", interpret=True))
    layers, _ = agent.stacked_params_from_jax(params, device="cpu")
    launches = ops.packed_qnet_stacked.launches
    got = ops.packed_qnet_stacked(layers, torch.from_numpy(bits),
                                  torch.from_numpy(frac))
    assert ops.packed_qnet_stacked.launches == launches   # no kernel on the CPU
    assert got.shape == (n_workers, c)
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
    # the dead worker's rows evaluate exactly like explicit zero input
    zero = ops.dense_qnet_stacked(layers, torch.zeros(n_workers, c, agent.STATE_DIM))
    assert torch.equal(got[1], zero[1])


def test_dense_loader_and_stacked_applies_agree_with_the_reference():
    params = _stacked_params(3, NARROW, seed=3)
    bits, frac = _planes(3, 9, seed=4)
    layers, _ = agent.stacked_params_from_jax(params, device="cpu")
    tb, tf = torch.from_numpy(bits), torch.from_numpy(frac)
    packed = ops.packed_qnet_stacked(layers, tb, tf)
    x = torch.cat([unpack_bits(tb), tf.unsqueeze(-1)], dim=-1)
    assert torch.equal(ops.dense_qnet_stacked(layers, x), packed)
    assert torch.equal(agent.apply_stacked(layers, x), packed)
    assert torch.equal(agent.apply_stacked_packed(layers, tb, tf), packed)
    net = JaxQNetwork(hidden=NARROW)
    want = np.asarray(net.apply_stacked(params, jnp.asarray(x.numpy())))
    np.testing.assert_allclose(packed.numpy(), want, atol=TOL, rtol=TOL)


def test_unpack_bits_is_exact_and_msb_first():
    bits, _ = _planes(2, 5, seed=9)
    got = unpack_bits(torch.from_numpy(bits))
    assert got.dtype == torch.float32 and got.shape == (2, 5, 2048)
    want = np.unpackbits(bits, axis=-1).astype(np.float32)
    assert got.numpy().tobytes() == want.tobytes()
    assert got.numpy().tobytes() == np.asarray(jax_unpack(jnp.asarray(bits))).tobytes()
    assert torch.equal(unpack_bits(torch.from_numpy(bits), n_bits=11), got[..., :11])
    one = torch.tensor([[0b10000001]], dtype=torch.uint8)
    assert unpack_bits(one).tolist() == [[1.0, 0, 0, 0, 0, 0, 0, 1.0]]


def _packed_batch(seed, B=6, C=5, prioritized=False):
    rng = np.random.default_rng(seed)
    out = {
        "state_bits": rng.integers(0, 256, (B, 256)).astype(np.uint8),
        "state_frac": rng.random(B).astype(np.float32),
        "rewards": rng.standard_normal(B).astype(np.float32),
        "dones": (rng.random(B) < 0.3).astype(np.float32),
        "next_bits": rng.integers(0, 256, (B, C, 256)).astype(np.uint8),
        "next_frac": rng.random(B).astype(np.float32),
        "next_counts": rng.integers(0, C + 3, B).astype(np.int32),
    }
    if prioritized:
        out["weights"] = rng.random(B).astype(np.float32)
    return out


@pytest.mark.parametrize("prioritized", [False, True])
def test_densify_batch_is_exact_against_host_and_reference(prioritized):
    host = _packed_batch(seed=5, prioritized=prioritized)
    got = densify_batch({k: torch.from_numpy(v) for k, v in host.items()})
    want_host = densify_sample(host)
    want_jax = jax_densify({k: jnp.asarray(v) for k, v in host.items()})
    assert set(got) == set(want_host) == set(want_jax)
    for k in got:
        assert got[k].numpy().tobytes() == np.asarray(want_host[k]).tobytes(), k
        assert got[k].numpy().tobytes() == np.asarray(want_jax[k]).tobytes(), k
    stacked = {k: np.stack([v, v]) for k, v in host.items()}
    again = densify_batch({k: torch.from_numpy(v) for k, v in stacked.items()})
    assert torch.equal(again["next_fps"][1], got["next_fps"])
    assert packed_nbytes(host) == sum(v.nbytes for v in host.values())
    assert dense_nbytes_equivalent(host) == sum(
        np.asarray(v).nbytes for v in want_host.values())


def test_pack_w1_matches_the_reference_layout():
    w1 = np.random.default_rng(2).standard_normal((3, 2049, 8)).astype(np.float32)
    w1r, w1f = pack_w1(torch.from_numpy(w1))
    assert w1r.shape == (3, 8, 256, 8) and w1f.shape == (3, 1, 8)
    jr, jf = jax.vmap(jax_pack_w1)(jnp.asarray(w1))
    assert np.array_equal(w1r.numpy(), np.asarray(jr))
    assert np.array_equal(w1f.numpy(), np.asarray(jf))
    assert torch.equal(w1r[2, 5, 100], torch.from_numpy(w1[2, 8 * 100 + 5]))


def _layers(n_workers=2, widths=(17, 5, 4, 3, 2, 1)):
    return [(torch.zeros(n_workers, i, o), torch.zeros(n_workers, o))
            for i, o in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("case", ["layers", "width", "last", "workers",
                                  "bias", "contiguous", "dtype"])
def test_wrapper_checks_what_the_kernel_takes(case):
    layers = _layers()
    if case == "layers":
        layers = layers[:4]
    elif case == "width":
        layers = _layers(widths=(16, 5, 4, 3, 2, 1))
    elif case == "last":
        layers = _layers(widths=(17, 5, 4, 3, 2, 2))
    elif case == "workers":
        layers = _layers(n_workers=3)
    elif case == "bias":
        layers[1] = (layers[1][0], torch.zeros(2, 5))
    elif case == "contiguous":
        layers[0] = (torch.zeros(2, 5, 17).transpose(1, 2), layers[0][1])
    elif case == "dtype":
        layers[3] = (layers[3][0].double(), layers[3][1])
    with pytest.raises(ValueError):
        ops._check_weights(layers, 2, 17, torch.device("cpu"))
    ops._check_weights(_layers(), 2, 17, torch.device("cpu"))
    with pytest.raises(ValueError, match="contiguous"):
        ops._check_rows(torch.zeros(2, 3, 2, dtype=torch.uint8), "bits",
                        torch.uint8, 2)


def test_wrapper_refuses_other_devices():
    bits = torch.zeros(2, 3, 2, dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.packed_qnet_stacked(_layers(), bits, torch.zeros(2, 3, device="meta"))
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.dense_qnet_stacked(_layers(), torch.zeros(2, 3, 17, device="meta"))


def test_library_hash_covers_the_shared_header(tmp_path, monkeypatch):
    """Both kernels include ``kernels/csrc/qnet_tiles.cuh``; an edit to it
    must rename (and so rebuild) both libraries."""
    packed = nvcc.NvccBuild(build.SOURCE)
    assert packed.library.name.startswith("libpacked_qnet-")
    header = nvcc.INCLUDE_DIR / "qnet_tiles.cuh"
    for src in (build.SOURCE, fused_build.SOURCE):
        assert header in nvcc.included_files(src)
    (tmp_path / "k.cu").write_text('#include "t.cuh"\n#include <cuda.h>\n')
    (tmp_path / "t.cuh").write_text("// v1\n")
    before = nvcc.NvccBuild(tmp_path / "k.cu").library
    (tmp_path / "t.cuh").write_text("// v2\n")
    assert nvcc.NvccBuild(tmp_path / "k.cu").library != before
    monkeypatch.setattr(nvcc, "INCLUDE_DIR", tmp_path / "nowhere")
    assert nvcc.included_files(tmp_path / "k.cu") == [
        (tmp_path / "k.cu").resolve(), (tmp_path / "t.cuh").resolve()]
