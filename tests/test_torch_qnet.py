"""The port's Q-network and its ``fused_qnet`` wrapper against the JAX
reference, at full width on the CPU.

Inputs are binary fingerprint rows plus a steps-left column, made with
numpy from a seed and handed to both packages; parameters are the
reference's own ``QNetwork.init`` tree carried over as numpy.  Both sides
sum in float32 in different orders, so Q agrees to 1e-5 (abs and rel),
the tolerance the port holds its host-side Q path to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.agent import QNetwork as JaxQNetwork
from repro.kernels.fused_qnet import ops as jax_qops
from repro_torch.core.agent import (HIDDEN_SIZES, STATE_DIM, QNetwork,
                                    params_from_jax, params_to_numpy)
from repro_torch.kernels import nvcc
from repro_torch.kernels.fused_qnet import build, ops
from repro_torch.kernels.fused_qnet.ref import qnet_ref

TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    tree = JaxQNetwork().init(jax.random.PRNGKey(11))
    return jax.tree_util.tree_map(np.asarray, tree)


def _states(n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    bits = (rng.random((n, STATE_DIM - 1)) < 0.2).astype(np.float32)
    frac = (rng.integers(0, 11, (n, 1)) / 10.0).astype(np.float32)
    return np.concatenate([bits, frac], axis=1)


def test_params_round_trip_bit_for_bit(jax_params):
    net = params_from_jax(jax_params, device="cpu")
    assert net.in_dim == STATE_DIM and net.hidden == HIDDEN_SIZES
    assert tuple(net.w[0].shape) == (STATE_DIM, 1024)     # [in, out], untransposed
    back = params_to_numpy(net)
    assert len(back["layers"]) == len(jax_params["layers"]) == 5
    for got, want in zip(back["layers"], jax_params["layers"]):
        for k in ("w", "b"):
            assert got[k].dtype == np.float32 and got[k].shape == want[k].shape
            assert got[k].tobytes() == np.asarray(want[k]).tobytes()


def test_qnetwork_matches_reference_apply(jax_params):
    x = _states(256, seed=1)
    want = np.asarray(JaxQNetwork().apply(jax_params, jnp.asarray(x)))
    with torch.no_grad():
        got = params_from_jax(jax_params, device="cpu")(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (256,)
    np.testing.assert_allclose(got, want, atol=TOL, rtol=TOL)


def test_qnetwork_forward_keeps_leading_dims(jax_params):
    x = _states(12, seed=2).reshape(3, 4, STATE_DIM)
    net = params_from_jax(jax_params, device="cpu")
    flat = net(torch.from_numpy(x.reshape(12, STATE_DIM)))
    assert torch.equal(net(torch.from_numpy(x)), flat.view(3, 4))


def test_qnetwork_init_is_seeded_he_normal():
    a = QNetwork(generator=torch.Generator().manual_seed(5), device="cpu")
    b = QNetwork(generator=torch.Generator().manual_seed(5), device="cpu")
    for (wa, ba), (wb, bb) in zip(a.layers(), b.layers()):
        assert torch.equal(wa, wb) and not ba.any() and not bb.any()
    std = float(a.w[0].std())
    assert abs(std - (2.0 / STATE_DIM) ** 0.5) < 0.05 * std


@pytest.mark.parametrize("n", [1, 5, 128, 300])
def test_fused_qnet_cpu_is_the_plain_version(jax_params, n):
    """On CPU tensors the wrapper runs ``ref.qnet_ref``; both agree with the
    reference's Pallas ``fused_qnet`` run in interpret mode."""
    x = _states(n, seed=100 + n)
    net = params_from_jax(jax_params, device="cpu")
    launches = ops.fused_qnet.launches
    q = ops.fused_qnet(net.layers(), torch.from_numpy(x))
    assert ops.fused_qnet.launches == launches      # no kernel on the CPU
    assert torch.equal(q, qnet_ref(torch.from_numpy(x), net.layers()))
    want = np.asarray(jax_qops.fused_qnet(jax_params, jnp.asarray(x),
                                          interpret=True))
    np.testing.assert_allclose(q.numpy(), want, atol=TOL, rtol=TOL)


def _small_layers(widths=(6, 5, 4, 3, 2, 1)):
    return [(torch.zeros(i, o), torch.zeros(o))
            for i, o in zip(widths[:-1], widths[1:])]


@pytest.mark.parametrize("case", ["layers", "width", "last", "dtype", "rank",
                                  "bias", "contiguous"])
def test_fused_qnet_checks_what_the_kernel_takes(case):
    layers, x = _small_layers(), torch.zeros(3, 6)
    if case == "layers":
        layers = layers[:4]
    elif case == "width":
        x = torch.zeros(3, 7)
    elif case == "last":
        layers = _small_layers((6, 5, 4, 3, 2, 2))
    elif case == "dtype":
        x = x.double()
    elif case == "rank":
        x = torch.zeros(6)
    elif case == "bias":
        layers[2] = (layers[2][0], torch.zeros(5))
    elif case == "contiguous":
        layers[0] = (torch.zeros(5, 6).t(), layers[0][1])
    with pytest.raises(ValueError):
        ops._check(x, layers)
    ops._check(torch.zeros(3, 6), _small_layers())


def test_fused_qnet_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        ops.fused_qnet(_small_layers(), torch.zeros(3, 6, device="meta"))


def test_kernel_library_is_named_by_its_source_and_flags(monkeypatch, tmp_path):
    b = nvcc.NvccBuild(build.SOURCE)
    assert b.library.parent == nvcc.REPO_ROOT / "build" / "repro_torch"
    assert b.library.name.startswith("libfused_qnet-")
    assert nvcc.NvccBuild(build.SOURCE).library == b.library
    assert "arch=compute_90a,code=sm_90a" in nvcc.FLAGS
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        nvcc.nvcc_path()
