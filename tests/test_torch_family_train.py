"""The gradients of the moe, encdec, vlm and granite configs, and granite's
forward, against the JAX reference on the CPU, at the reduced configs in
f32 (B 2, S 32).

``launch/train.py --mode lm`` trains every registered config, so each
family's gradient is on a path.  Parameters are the reference's own
``init_params`` trees carried over as numpy; tokens, frames and patches are
numpy from a seed.  Tolerances are ``tests/test_torch_lm_train.py``'s:
the loss within 1e-5 relative, every gradient leaf within 1e-4 of that
leaf's max |g|; granite's logits within the 1e-4 abs + rel that
``tests/test_torch_families.py`` holds the forward to.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.models import forward_train as jax_forward
from repro.models import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro_torch.configs import get_config
from repro_torch.launch.steps import loss_and_grads
from repro_torch.models import forward_train, params_from_numpy

GRAD_ARCHS = ["mixtral-8x22b", "qwen3-moe-235b-a22b", "whisper-large-v3",
              "paligemma-3b", "yi-34b", "granite-20b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4             # of the leaf's max |g|
FWD_TOL = 1e-4


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfgs(arch, **changes):
    ref = dataclasses.replace(jax_get_config(arch).reduced(), **changes)
    return ref, dataclasses.replace(get_config(arch).reduced(), **changes)


def _reference(cfg, seed=1):
    return jax.tree_util.tree_map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(seed)))


def _batch(cfg, B=2, S=32, seed=0) -> dict:
    """Tokens, next-token labels, a mask with ~10% zeros, and the family's
    stub frames or patches, numpy from one seeded stream."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    batch = {"tokens": tokens,
             "labels": np.concatenate([tokens[:, 1:], np.zeros((B, 1), np.int32)], 1),
             "mask": (rng.random((B, S)) > 0.1).astype(np.float32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.vision_dim)).astype(np.float32)
    return batch


def _ref_value_and_grad(params, cfg, batch):
    loss, grads = jax.jit(jax.value_and_grad(jax_loss_fn), static_argnums=1)(
        params, cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _assert_loss_and_grads(ref_cfg, cfg, params, batch):
    want_loss, want = _ref_value_and_grad(params, ref_cfg, batch)
    loss, got = loss_and_grads(params_from_numpy(params, device="cpu"), cfg, batch)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    assert len(got) == len(want)
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape and g.dtype == torch.float32, i
        scale = max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=f"leaf {i}")
    return want_loss


@pytest.mark.parametrize("arch", GRAD_ARCHS)
def test_loss_and_grads_match_the_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    _assert_loss_and_grads(ref_cfg, cfg, _reference(ref_cfg), _batch(ref_cfg))


def test_moe_gradient_at_a_routing_that_changes_the_loss():
    """The reduced mixtral and qwen3-moe give the same loss bits, so the
    MoE gradient is also held at top-1 routing, which the reference first
    shows to change the loss of the same parameters and batch."""
    ref_cfg, cfg = _cfgs("qwen3-moe-235b-a22b")
    params, batch = _reference(ref_cfg, seed=3), _batch(ref_cfg, seed=4)
    top1 = dataclasses.replace(ref_cfg.moe, top_k=1)
    ref1, cfg1 = (dataclasses.replace(c, moe=top1) for c in (ref_cfg, cfg))
    base = _ref_value_and_grad(params, ref_cfg, batch)[0]
    changed = _assert_loss_and_grads(ref1, cfg1, params, batch)
    assert abs(changed - base) > 1e-3 * abs(base), (changed, base)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ["granite-20b", "granite-34b"])
def test_granite_forward_matches_the_reference(arch, use_pallas):
    """MQA (one kv head): logits and the aux loss on both routes; the
    kernel route runs the reference's Pallas attention in interpret mode
    and the port's plain version of the kernel."""
    ref_cfg, cfg = _cfgs(arch, use_pallas=use_pallas)
    assert ref_cfg.n_kv_heads == 1
    params, batch = _reference(ref_cfg), _batch(ref_cfg)
    want, want_aux = jax_forward(params, ref_cfg, {k: jnp.asarray(v) for k, v in batch.items()})
    got, aux = forward_train(params_from_numpy(params, device="cpu"), cfg, batch)
    assert got.shape == (2, 32, ref_cfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=FWD_TOL, rtol=FWD_TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=FWD_TOL, rtol=FWD_TOL)
