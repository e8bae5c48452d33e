"""The port's moe, encdec and vlm families (and the dense configs that came
with them) against the JAX reference, on the CPU, at the reduced configs in
f32.

Parameters are the reference's own ``init_params`` trees carried over as
numpy (``params_from_numpy``); tokens, encoder frames and image patches are
made with numpy from a seed and handed to both packages.  Logits, losses
(the MoE aux term included) and decode caches are held to 1e-4 abs + 1e-4
rel: both packages compute in f32, in other summation orders.  With
``use_pallas`` the reference runs its Pallas attention in interpret mode and
the port the kernel's plain version (CPU tensors)."""

import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_config_fields import with_port_only_fields
from repro.configs import get_config as jax_get_config
from repro.models import count_params as jax_count_params
from repro.models import forward_train as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.models import serve_step as jax_serve_step
from repro.models.model import active_params as jax_active_params
from repro.models.moe import moe_forward as jax_moe_forward
from repro_torch.configs import get_config
from repro_torch.launch.steps import make_prefill_step, make_serve_step
from repro_torch.models import (active_params, count_params, forward_train,
                                init_cache, init_params, loss_fn,
                                params_from_numpy, params_to_numpy, serve_step)
from repro_torch.models import moe as Moe

ROOT = Path(__file__).resolve().parents[1]
NEW_ARCHS = ["granite-20b", "granite-34b", "mixtral-8x22b", "paligemma-3b",
             "qwen3-moe-235b-a22b", "whisper-large-v3", "yi-34b"]
FAMILY_ARCHS = ["mixtral-8x22b", "qwen3-moe-235b-a22b", "whisper-large-v3",
                "paligemma-3b"]
# the reference's count_params at full width (the chip phase's table)
FULL_PARAMS = {
    "granite-20b": (28_167_493_632, 28_167_493_632),
    "granite-34b": (47_249_922_048, 47_249_922_048),
    "mixtral-8x22b": (140_630_071_296, 39_161_468_928),
    "paligemma-3b": (2_433_822_720, 2_433_822_720),
    "qwen3-moe-235b-a22b": (235_093_610_496, 22_190_739_456),
    "whisper-large-v3": (1_602_910_720, 1_602_910_720),
    "yi-34b": (34_388_917_248, 34_388_917_248),
}
TOL = 1e-4


def _reference(cfg, seed=1):
    return jax.tree_util.tree_map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(seed)))


def _batch(cfg, B, S, seed=0) -> dict:
    """Tokens, next-token labels, a mask with the last position off, and the
    family's stub frames or patches, all numpy from one seeded stream."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, cfg.vocab, (B, S)).astype(np.int32)
    mask = np.ones((B, S), np.float32)
    mask[:, -1] = 0.0
    batch = {"tokens": tokens, "labels": np.roll(tokens, -1, axis=1), "mask": mask}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.encdec.n_frames, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["patches"] = rng.standard_normal(
            (B, cfg.vlm.n_patches, cfg.vlm.vision_dim)).astype(np.float32)
    return batch


def _jnp(batch: dict) -> dict:
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _close(got: torch.Tensor, want, tol=TOL):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


def _cfgs(arch, **changes):
    return (dataclasses.replace(jax_get_config(arch).reduced(), **changes),
            dataclasses.replace(get_config(arch).reduced(), **changes))


# ------------------------------------------------------------------ #
# configs and parameter trees
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_equal_the_reference_field_by_field(arch):
    ref, port = jax_get_config(arch), get_config(arch)
    assert dataclasses.asdict(port) == with_port_only_fields(dataclasses.asdict(ref))
    assert dataclasses.asdict(port.reduced()) == \
        with_port_only_fields(dataclasses.asdict(ref.reduced()))
    assert dataclasses.asdict(port.with_window(64)) == \
        with_port_only_fields(dataclasses.asdict(ref.with_window(64)))
    assert port.torch_dtype == torch.bfloat16
    assert port.resolved_head_dim == ref.resolved_head_dim


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_counts_equal_the_reference_at_full_width(arch):
    """``count_params`` and ``active_params`` from a meta tree, against the
    reference's ``eval_shape`` counts and the numbers the chip phase quotes."""
    cfg, ref = get_config(arch), jax_get_config(arch)
    want = (jax_count_params(ref), jax_active_params(ref))
    assert (count_params(cfg), active_params(cfg)) == want == FULL_PARAMS[arch]


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_init_params_has_the_reference_tree(arch):
    """Same key paths, shapes and per-leaf types as the reference's init, at
    bf16: the MoE router stays f32 in a bf16 tree."""
    ref_cfg, cfg = _cfgs(arch, dtype="bfloat16")
    ref = _reference(ref_cfg, seed=0)
    mine = params_to_numpy(init_params(cfg, 3, device="cpu"))
    flat_ref = jax.tree_util.tree_flatten_with_path(ref)[0]
    flat_mine = jax.tree_util.tree_flatten_with_path(mine)[0]
    assert [p for p, _ in flat_ref] == [p for p, _ in flat_mine]
    for (path, a), (_, b) in zip(flat_ref, flat_mine):
        assert a.shape == b.shape and a.dtype == b.dtype, path


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_params_from_numpy_carries_the_new_leaves(arch):
    """The router (f32 in a bf16 tree), the stacked ``[L, E, D, F]`` experts,
    cross-attention, the encoder and the vision projector cross bit for bit."""
    ref_cfg, _ = _cfgs(arch, dtype="bfloat16")
    ref = _reference(ref_cfg, seed=2)
    tp = params_from_numpy(ref, device="cpu")
    blocks = tp["blocks"]
    if "moe" in blocks:
        assert blocks["moe"]["router"].dtype == torch.float32
        assert blocks["moe"]["w1"].dtype == torch.bfloat16
        assert blocks["moe"]["w1"].shape == (ref_cfg.n_layers, ref_cfg.moe.n_experts,
                                             ref_cfg.d_model, ref_cfg.d_ff)
    if ref_cfg.family == "encdec":
        assert set(blocks) >= {"cross", "norm_x"}
        assert set(tp) >= {"enc_blocks", "enc_pos", "enc_final_norm"}
    if ref_cfg.family == "vlm":
        assert tp["vision_proj"]["w"].shape == (ref_cfg.vlm.vision_dim, ref_cfg.d_model)
    back = params_to_numpy(tp)
    for (path, a), (_, b) in zip(jax.tree_util.tree_flatten_with_path(ref)[0],
                                 jax.tree_util.tree_flatten_with_path(back)[0]):
        assert a.dtype == b.dtype, path
        np.testing.assert_array_equal(a.view(np.uint8), b.view(np.uint8))


def test_qnet_family_names_its_roadmap_item():
    """The qnet family (damoldqn) builds the reference's QNetwork tree,
    shapes and types, on the CPU and on ``meta``; it has no LM cache or
    forward, and raises ValueError there as the reference's init_cache does."""
    cfg = get_config("damoldqn")
    ref = jax_init_params(jax_get_config("damoldqn"), jax.random.PRNGKey(0))
    want = [(tuple(l.shape), str(l.dtype)) for l in jax.tree_util.tree_leaves(ref)]
    for device in ("cpu", "meta"):
        tree = init_params(cfg, 0, device=device)
        assert set(tree) == {"layers"} and all(set(l) == {"w", "b"} for l in tree["layers"])
        got = [(tuple(t.shape), str(t.dtype).split(".")[1])
               for l in tree["layers"] for t in (l["b"], l["w"])]
        assert got == want
    assert count_params(cfg) == jax_count_params(jax_get_config("damoldqn"))
    with pytest.raises(ValueError):
        jax_init_cache(jax_get_config("damoldqn"), 1, 4)
    with pytest.raises(ValueError, match="qnet"):
        init_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="qnet"):
        forward_train(init_params(cfg, 0, device="cpu"), cfg, {"tokens": np.ones((1, 4))})


# ------------------------------------------------------------------ #
# forward, loss
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", FAMILY_ARCHS + ["yi-34b"])
def test_forward_train_matches_the_reference(arch, use_pallas):
    """Logits and the aux loss (the MoE load balance; 0 elsewhere)."""
    ref_cfg, cfg = _cfgs(arch, use_pallas=use_pallas)
    params = _reference(ref_cfg)
    batch = _batch(ref_cfg, 2, 32)
    want, want_aux = jax_forward(params, ref_cfg, _jnp(batch))
    got, aux = forward_train(params_from_numpy(params, device="cpu"), cfg, batch)
    assert got.shape == (2, 32, ref_cfg.vocab)
    _close(got, want)
    _close(aux, want_aux)
    assert (float(aux) > 0.0) == (ref_cfg.family == "moe")


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_loss_fn_matches_the_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    params = _reference(ref_cfg, seed=5)
    batch = _batch(ref_cfg, 2, 32, seed=6)
    want = jax_loss_fn(params, ref_cfg, _jnp(batch))
    got = loss_fn(params_from_numpy(params, device="cpu"), cfg, batch)
    _close(got, want)


@pytest.mark.parametrize("use_pallas", [False, True], ids=["plain", "kernels"])
def test_paligemma_at_head_dim_256_matches_the_reference(use_pallas):
    """The reduced paligemma-3b at the full config's head dim of 256 (the
    kernel's new width) through both routes: the only CPU path at D = 256."""
    D = jax_get_config("paligemma-3b").resolved_head_dim
    assert D == 256
    ref_cfg, cfg = _cfgs("paligemma-3b", head_dim=D, use_pallas=use_pallas)
    params = _reference(ref_cfg, seed=7)
    assert params["blocks"]["attn"]["wq"].shape[-1] == 256
    batch = _batch(ref_cfg, 2, 24, seed=8)
    want, _ = jax_forward(params, ref_cfg, _jnp(batch))
    got, _ = forward_train(params_from_numpy(params, device="cpu"), cfg, batch)
    _close(got, want)


def test_vlm_returns_text_positions_only():
    """The image prefix is attended to but sliced off the returned hidden
    states; patches change the text logits."""
    ref_cfg, cfg = _cfgs("paligemma-3b")
    tp = params_from_numpy(_reference(ref_cfg, seed=9), device="cpu")
    batch = _batch(ref_cfg, 1, 16, seed=10)
    a, _ = forward_train(tp, cfg, batch)
    assert a.shape == (1, 16, cfg.vocab)
    b, _ = forward_train(tp, cfg, {**batch, "patches": batch["patches"] * 2.0})
    assert not torch.allclose(a, b)


# ------------------------------------------------------------------ #
# the MoE layer alone
# ------------------------------------------------------------------ #
def _moe_setup(capacity_factor, seed=0, E=8, K=2, group=16):
    from repro.configs.base import ArchConfig as JaxArch
    from repro.configs.base import MoEConfig as JaxMoE
    from repro_torch.configs.base import ArchConfig, MoEConfig
    kw = dict(name="t", family="moe", n_layers=1, d_model=32, n_heads=4,
              n_kv_heads=4, d_ff=64, vocab=64, dtype="float32")
    mk = dict(n_experts=E, top_k=K, capacity_factor=capacity_factor, group_size=group)
    rng = np.random.default_rng(seed)
    p = {"router": rng.standard_normal((32, E)).astype(np.float32) * 0.3,
         "w1": rng.standard_normal((E, 32, 64)).astype(np.float32) * 0.2,
         "w3": rng.standard_normal((E, 32, 64)).astype(np.float32) * 0.2,
         "w2": rng.standard_normal((E, 64, 32)).astype(np.float32) * 0.2}
    x = rng.standard_normal((2, 32, 32)).astype(np.float32)
    return (JaxArch(**kw, moe=JaxMoE(**mk)), ArchConfig(**kw, moe=MoEConfig(**mk)),
            p, x)


@pytest.mark.parametrize("capacity_factor", [1.0, 4.0])
def test_moe_forward_matches_the_reference(capacity_factor):
    """At 1.0 tokens are dropped at capacity, at 4.0 none: both as the
    reference's GShard dispatch does."""
    jcfg, cfg, p, x = _moe_setup(capacity_factor)
    want, want_aux = jax_moe_forward({k: jnp.asarray(v) for k, v in p.items()},
                                     jnp.asarray(x), jcfg)
    got, aux = Moe.moe_forward({k: torch.from_numpy(v) for k, v in p.items()},
                               torch.from_numpy(x), cfg)
    _close(got, want)
    _close(aux, want_aux)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_moe_gate_indices_equal_lax_top_k_where_the_margin_is_clear(seed):
    """The chosen experts and their order equal ``jax.lax.top_k``'s wherever
    the top-k margin (k-th minus (k+1)-th probability) exceeds 1e-5, and a
    tie goes to the lower index, as lax.top_k's does."""
    jcfg, cfg, p, x = _moe_setup(1.0, seed=seed, E=16, K=4)
    xt = x.reshape(4, 16, 32)
    probs, vals, idx = Moe.route(torch.from_numpy(p["router"]), torch.from_numpy(xt), 4)
    jprobs = jax.nn.softmax(jnp.asarray(xt) @ jnp.asarray(p["router"]), axis=-1)
    jvals, jidx = jax.lax.top_k(jprobs, 4)
    srt = np.sort(np.asarray(jprobs), axis=-1)[..., ::-1]
    clear = (srt[..., :4] - srt[..., 1:5]).min(axis=-1) > 1e-5
    assert clear.mean() > 0.9
    np.testing.assert_array_equal(idx.numpy()[clear], np.asarray(jidx)[clear])
    np.testing.assert_allclose(probs.numpy(), np.asarray(jprobs), atol=1e-6)
    tie = torch.tensor([[[0.25, 0.25, 0.25, 0.25]]])
    _, _, tidx = Moe.route(torch.eye(4), tie.log(), 2)
    assert tidx.tolist() == [[[0, 1]]]


def test_moe_conserves_tokens_at_capacity_factor_4():
    """At capacity factor 4 no (token, choice) is dropped: each token's
    output is its top-k experts' outputs weighted by its renormalised gates,
    computed here token by token."""
    _, cfg, p, x = _moe_setup(4.0)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    xt = torch.from_numpy(x)
    y, aux = Moe.moe_forward(tp, xt, cfg)
    _, gates, idx = Moe.route(tp["router"], xt.reshape(-1, 1, 32), 2)
    want = torch.zeros_like(y).reshape(-1, 32)
    for t, row in enumerate(xt.reshape(-1, 32)):
        for g, e in zip(gates[t, 0], idx[t, 0]):
            h = torch.nn.functional.silu(row @ tp["w1"][e]) * (row @ tp["w3"][e])
            want[t] += g * (h @ tp["w2"][e])
    np.testing.assert_allclose(y.reshape(-1, 32).numpy(), want.numpy(),
                               atol=1e-5, rtol=1e-5)
    assert torch.isfinite(aux) and float(aux) >= 0.0


# ------------------------------------------------------------------ #
# decode
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", FAMILY_ARCHS + ["yi-34b"])
def test_init_cache_shapes_match_the_reference(arch):
    ref_cfg, cfg = _cfgs(arch)
    want = jax_init_cache(ref_cfg, 2, 16)
    got = init_cache(cfg, 2, 16, device="cpu")
    assert list(got) == list(want)
    for key, val in want.items():
        if key == "pos":
            assert got["pos"] == 0
        else:
            assert tuple(got[key].shape) == val.shape
            assert str(got[key].dtype).split(".")[1] == str(val.dtype)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_serve_step_matches_the_reference_step_by_step(arch):
    """Logits and every cache tensor, step by step over 8 tokens, from the
    reference's zero caches: the encdec cross K/V and the vlm image-prefix
    slots stay zero and are attended to, as in the reference (ROADMAP C3)."""
    ref_cfg, cfg = _cfgs(arch)
    params = _reference(ref_cfg, seed=3)
    tp = params_from_numpy(params, device="cpu")
    B, S = 2, 8
    tokens = _batch(ref_cfg, B, S, seed=4)["tokens"]
    jcache = jax_init_cache(ref_cfg, B, S)
    tcache = init_cache(cfg, B, S, device="cpu")
    step = make_serve_step(cfg)
    for t in range(S):
        jl, jcache = jax_serve_step(params, ref_cfg, jcache, jnp.asarray(tokens[:, t:t + 1]))
        tl, tcache = step(tp, tcache, tokens[:, t:t + 1])
        _close(tl, jl)
        assert tcache["pos"] == int(jcache["pos"]) == t + 1
        for key, val in jcache.items():
            if key != "pos":
                _close(tcache[key], val)
    for key in ("cross_k", "cross_v"):
        if key in tcache:
            assert not tcache[key].any()
    if ref_cfg.family == "vlm":
        assert not tcache["k"][:, :, :ref_cfg.vlm.n_patches].any()


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "qwen3-moe-235b-a22b"])
def test_moe_decode_matches_forward_where_nothing_was_dropped(arch):
    """``tests/test_models.py::test_decode_matches_forward_moe`` in the port:
    the grouped forward may drop (token, choice) pairs at capacity 1.0, a
    single-token decode group never does; positions the forward did not
    drop match teacher forcing, the first always."""
    cfg = dataclasses.replace(get_config(arch).reduced(), use_pallas=True)
    params = init_params(cfg, 4, device="cpu")
    S = 8
    tokens = _batch(cfg, 1, S, seed=1)["tokens"]
    full = make_prefill_step(cfg)(params, {"tokens": tokens})
    cache = init_cache(cfg, 1, S, device="cpu")
    outs = []
    for t in range(S):
        lg, cache = serve_step(params, cfg, cache, tokens[:, t:t + 1])
        outs.append(lg[:, 0])
    per_pos = (torch.stack(outs, dim=1) - full).abs().amax(dim=-1)[0]
    matched = per_pos < 1e-3
    assert matched[0] and int(matched.sum()) >= S // 2, per_pos


# ------------------------------------------------------------------ #
# the launchers, in subprocesses on the CPU
# ------------------------------------------------------------------ #
def _run(args: list[str]) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-m", *args],
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          cwd=ROOT, capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("arch", ["mixtral-8x22b", "whisper-large-v3"])
def test_serve_launcher_runs_the_family_on_the_cpu(arch):
    res = _run(["repro_torch.launch.serve", "--device", "cpu", "--arch", arch,
                "--batch", "2", "--prompt-len", "4", "--new-tokens", "4"])
    assert res.returncode == 0, res.stderr
    assert f"arch={arch} batch=2 decode 8 tokens" in res.stdout
    assert "tok/s on cpu" in res.stdout


def test_train_launcher_feeds_stub_patches_from_default_rng_0():
    """``launch.train --mode lm --reduced --arch paligemma-3b`` for 3 steps:
    finite losses, and the first equals the loss of ``init_params(cfg, 0)``
    on the first batch with patches drawn first from
    ``np.random.default_rng(0)``, as the reference launcher draws them
    (patches from another stream give another loss)."""
    from repro_torch.launch.train import lm_batches, with_stub_inputs
    res = _run(["repro_torch.launch.train", "--mode", "lm", "--reduced",
                "--device", "cpu", "--arch", "paligemma-3b", "--steps", "3",
                "--batch", "4", "--seq", "32"])
    assert res.returncode == 0, res.stderr
    losses = [float(v) for v in re.findall(r"\[step +\d+\] loss ([0-9.naninf]+)",
                                           res.stdout)]
    final = float(re.search(r'"final_loss": ([^,]+),', res.stdout).group(1))
    assert losses and np.isfinite(losses + [final]).all()

    cfg = get_config("paligemma-3b").reduced()
    params = init_params(cfg, 0, device="cpu")
    first = next(with_stub_inputs(cfg, lm_batches(4, 32)))
    rng = np.random.default_rng(0)
    np.testing.assert_array_equal(first["patches"], rng.standard_normal(
        (4, cfg.vlm.n_patches, cfg.vlm.vision_dim)).astype(np.float32))
    want = float(loss_fn(params, cfg, first))
    assert abs(losses[0] - want) <= 1e-4
    other = np.random.default_rng(1).standard_normal(first["patches"].shape)
    assert abs(float(loss_fn(params, cfg, {**first, "patches": other})) - want) > 1e-3
