"""The port's model zoo (dense, ssm, hybrid) against the JAX reference, on
the CPU, at the reduced configs in f32.

Parameters are the reference's own ``init_params`` trees carried over as
numpy (``params_from_numpy``); tokens are made with numpy from a seed and
handed to both packages.  Logits and decode caches are held to 1e-4 abs +
1e-4 rel: both packages compute in f32, in other summation orders (the
reference's einsums and scans against the port's matmuls and loops);
measured differences are ~1e-5 on logits of scale ~5.  With ``use_pallas``
the reference runs its Pallas kernels in interpret mode and the port its
kernels' plain versions (CPU tensors)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import count_params as jax_count_params
from repro.models import forward_train as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import serve_step as jax_serve_step
from repro_torch.configs import get_config, list_archs
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import (count_params, forward_train, init_cache,
                                init_params, params_from_numpy,
                                params_to_numpy, serve_step)
from repro_torch.models.model import hybrid_n_apps

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["zamba2-1.2b", "mamba2-2.7b", "stablelm-1.6b"]
TOL = 1e-4


def _reference(arch, seed=1):
    cfg = jax_get_config(arch).reduced()
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(cfg, jax.random.PRNGKey(seed)))
    return cfg, params


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(1, cfg.vocab, (B, S)).astype(np.int32)


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def test_registry_holds_the_ported_archs():
    """Every config of the reference: the LM configs and its qnet config
    (damoldqn), the latter equal to the reference's field by field."""
    from repro.configs import list_archs as jax_list_archs
    assert list_archs() == sorted(ARCHS + [
        "damoldqn", "granite-20b", "granite-34b", "mixtral-8x22b", "paligemma-3b",
        "qwen3-moe-235b-a22b", "whisper-large-v3", "yi-34b"])
    assert list_archs() == jax_list_archs()
    assert dataclasses.asdict(get_config("damoldqn")) == \
        dataclasses.asdict(jax_get_config("damoldqn"))
    with pytest.raises(KeyError):
        get_config("no-such-arch")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_equal_the_reference_field_by_field(arch):
    ref, port = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(port.reduced()) == dataclasses.asdict(ref.reduced())
    assert dataclasses.asdict(port.with_window(64)) == \
        dataclasses.asdict(ref.with_window(64))
    assert port.torch_dtype == torch.bfloat16
    assert port.reduced().torch_dtype == torch.float32
    assert port.resolved_head_dim == ref.resolved_head_dim


@pytest.mark.parametrize("arch", ARCHS)
def test_count_params_equals_the_reference_at_full_width(arch):
    assert count_params(get_config(arch)) == jax_count_params(jax_get_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """Same key paths, shapes and per-leaf types as the reference's init."""
    cfg = dataclasses.replace(jax_get_config(arch).reduced(), dtype="bfloat16")
    ref = jax.tree_util.tree_map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(0)))
    mine = params_to_numpy(init_params(
        dataclasses.replace(get_config(arch).reduced(), dtype="bfloat16"), 3,
        device="cpu"))
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_mine = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_mine]
    for (path, a), (_, b) in zip(flat_ref, flat_mine):
        assert a.shape == b.shape and a.dtype == b.dtype, path


def test_params_from_numpy_round_trips_bf16_and_f32_leaves():
    """A bf16 reference tree (with its f32 SSM leaves) crosses bit for bit."""
    cfg = dataclasses.replace(jax_get_config("zamba2-1.2b").reduced(),
                              dtype="bfloat16")
    ref = jax.tree_util.tree_map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(2)))
    tp = params_from_numpy(ref, device="cpu")
    assert tp["embed"].dtype == torch.bfloat16
    assert tp["blocks"]["ssm"]["A_log"].dtype == torch.float32
    assert tp["blocks"]["ssm"]["in_z"].shape == ref["blocks"]["ssm"]["in_z"].shape
    back = params_to_numpy(tp)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                 jax.tree_util.tree_flatten_with_path(back)[0]):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_the_reference(arch, use_pallas):
    cfg, params = _reference(arch)
    cfg = dataclasses.replace(cfg, use_pallas=use_pallas)
    tokens = _tokens(cfg, 2, 32)
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(tokens)})
    pcfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=use_pallas)
    got, aux = forward_train(params_from_numpy(params, device="cpu"), pcfg,
                             {"tokens": tokens})
    assert got.shape == (2, 32, cfg.vocab) and float(aux) == 0.0
    _close(got, want)


def test_mamba2_state_dim_128_through_the_kernel_route():
    """The reduced mamba2-2.7b at the full config's N = 128 with
    ``use_pallas``: the reference runs its Pallas scan, the port its
    ``ssd_scan`` wrapper (which takes N <= 128), from one parameter tree."""
    def widen(cfg):
        return dataclasses.replace(cfg, use_pallas=True, ssm=dataclasses.replace(
            cfg.ssm, state_dim=jax_get_config("mamba2-2.7b").ssm.state_dim))

    cfg = widen(jax_get_config("mamba2-2.7b").reduced())
    assert cfg.ssm.state_dim == 128
    params = jax.tree_util.tree_map(
        np.asarray, jax_init_params(cfg, jax.random.PRNGKey(4)))
    tokens = _tokens(cfg, 2, 32)
    want, _ = jax_forward(params, cfg, {"tokens": jnp.asarray(tokens)})
    pcfg = widen(get_config("mamba2-2.7b").reduced())
    got, _ = forward_train(params_from_numpy(params, device="cpu"), pcfg,
                           {"tokens": tokens})
    assert got.shape == (2, 32, cfg.vocab)
    _close(got, want)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_step_matches_the_reference_step_by_step(arch):
    """Logits and every cache tensor, step by step over 8 tokens; the
    hybrid's per-application shared KV caches included."""
    cfg, params = _reference(arch, seed=3)
    tp = params_from_numpy(params, device="cpu")
    pcfg = get_config(arch).reduced()
    B, S = 2, 8
    tokens = _tokens(cfg, B, S, seed=4)
    jcache = jax_init_cache(cfg, B, S)
    tcache = init_cache(pcfg, B, S, device="cpu")
    step = make_serve_step(pcfg)
    for t in range(S):
        jl, jcache = jax_serve_step(params, cfg, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = step(tp, tcache, tokens[:, t:t + 1])
        _close(tl, jl)
        assert tcache["pos"] == int(jcache["pos"]) == t + 1
        for key, val in jcache.items():
            if key != "pos":
                _close(tcache[key], val)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_forward_inside_the_port(arch):
    """Teacher-forced decode against the kernel-route forward (the plain
    versions here), within ``tests/test_models.py``'s 2e-2."""
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    params = init_params(cfg, 5, device="cpu")
    tokens = _tokens(cfg, 1, 16, seed=6)
    full = make_prefill_step(cfg)(params, {"tokens": tokens})
    cache = init_cache(cfg, 1, 16, device="cpu")
    outs = []
    for t in range(16):
        lg, cache = serve_step(params, cfg, cache, tokens[:, t:t + 1])
        outs.append(lg[:, 0])
    dec = torch.stack(outs, dim=1)
    np.testing.assert_allclose(dec.numpy(), full.numpy(), atol=2e-2, rtol=2e-2)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_cache_shapes_match_the_reference(arch):
    cfg = jax_get_config(arch).reduced()
    want = jax_init_cache(cfg, 2, 16)
    got = init_cache(get_config(arch).reduced(), 2, 16, device="cpu")
    assert set(got) == set(want)
    for key, val in want.items():
        if key == "pos":
            assert got["pos"] == 0
        else:
            assert tuple(got[key].shape) == val.shape
            assert str(got[key].dtype).split(".")[1] == str(val.dtype)
    if arch == "zamba2-1.2b":
        assert got["shared_k"].shape[0] == hybrid_n_apps(get_config(arch).reduced()) >= 1


def test_launcher_on_the_cpu():
    """``python -m repro_torch.launch.serve --device cpu`` at the reference
    launcher's other defaults; the default device is the GPU."""
    from repro_torch.launch.serve import parser
    args = parser().parse_args([])
    assert args.device == "cuda" and args.reduced is True
    assert args.arch == "stablelm-1.6b"
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--arch", "zamba2-1.2b", "--batch", "2", "--prompt-len", "4",
         "--new-tokens", "4"],
        env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert "arch=zamba2-1.2b batch=2 decode 8 tokens" in res.stdout
    assert "tok/s on cpu" in res.stdout
