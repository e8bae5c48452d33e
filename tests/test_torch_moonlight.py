"""moonlight-16b-a3b (the port-only mla_moe family) against its plain f32
reference ``repro_torch.models.moonlight_ref``, on the CPU at reduced
sizes, from the program's own seeded parameters.

The program runs in f32 here (the reduced configs' type); both sides
compute the same equations in other orders (SDPA against explicit
blocked softmax, a sort-and-group dispatch against a loop of boolean
selections), so logits, losses and gradients agree to ~1e-6 and are held
to 1e-4 (rel, or of a leaf's largest element).  The share test ties the
expert share to the uncut layer; the launcher and the parameter counts
at the published widths come last."""

import dataclasses
import json

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core.spans import SpanRecorder
from repro_torch.launch.steps import loss_and_grads, make_train_step
from repro_torch.models import (active_params, count_params, forward_train,
                                init_cache, init_params, loss_fn, param_pspecs,
                                serve_step)
from repro_torch.models import mla as Mla
from repro_torch.models import moe as Moe
from repro_torch.models import moonlight_ref as R
from repro_torch.models.model import leaves_with_paths

TOL = 1e-4
ARCH = "moonlight-16b-a3b"


def _cfg(**moe):
    """The reduced config with 3 layers (1 dense + 2 MoE), 8 experts, top 3,
    q.k head dim 24 against v's 16, and the given MoE overrides."""
    cfg = get_config(ARCH).reduced()
    cfg = dataclasses.replace(cfg, n_layers=3, d_model=64, d_ff=32, vocab=128)
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=3, dense_d_ff=48, **moe))


def _batch(cfg, B=2, S=40, seed=0):
    g = torch.Generator().manual_seed(seed)
    ids = torch.randint(0, cfg.vocab, (B, S + 1), generator=g)
    return {"tokens": ids[:, :-1], "labels": ids[:, 1:], "mask": torch.ones(B, S)}


def _params(cfg, seed=1):
    """Seeded parameters, the biases moved off zero so they select."""
    p = init_params(cfg, seed, device="cpu")
    g = torch.Generator().manual_seed(seed + 100)
    bias = p["blocks"]["moe"]["bias"]
    p["blocks"]["moe"]["bias"] = 0.05 * torch.randn(bias.shape, generator=g)
    return p


def _first(tree):
    """Layer 0 of a stacked subtree."""
    return {k: _first(v) if isinstance(v, dict) else v[0] for k, v in tree.items()}


def _close(got, want, tol=TOL):
    got, want = got.detach().float(), want.detach().float()
    scale = max(float(want.abs().max()), 1e-30)
    assert float((got - want).abs().max()) <= tol * scale, \
        (float((got - want).abs().max()), scale)


def test_config_keeps_every_published_width():
    cfg = get_config(ARCH)
    assert (cfg.family, cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.d_ff,
            cfg.vocab, cfg.rope_theta, cfg.norm_eps) == \
        ("mla_moe", 27, 2048, 16, 1408, 163840, 50000.0, 1e-5)
    m, a = cfg.moe, cfg.mla
    assert (m.n_experts, m.top_k, m.routed_scale, m.n_shared, m.first_dense,
            m.dense_d_ff, m.expert_share) == (64, 6, 2.446, 2, 1, 11264, None)
    assert (a.kv_lora_rank, a.qk_nope_head_dim, a.qk_rope_head_dim,
            a.v_head_dim) == (512, 128, 64, 128)


def test_parameter_counts_at_published_widths_and_at_the_share():
    cfg = get_config(ARCH)
    assert count_params(cfg) == 15_960_110_208          # "16B"
    assert 2.9e9 < active_params(cfg) < 3.0e9            # "A3B"
    share = dataclasses.replace(cfg, vocab=20480, moe=dataclasses.replace(
        cfg.moe, expert_share=(0, 8)))
    assert count_params(share) == 2_777_412_736
    shapes = dict(leaves_with_paths(init_params(share, device="meta")))
    assert tuple(shapes[("blocks", "moe", "w1")].shape) == (26, 8, 2048, 1408)
    assert tuple(shapes[("blocks", "moe", "router")].shape) == (26, 2048, 64)
    assert tuple(shapes[("blocks", "attn", "wkv_a")].shape) == (26, 2048, 576)
    assert tuple(shapes[("dense_blocks", "mlp", "w1")].shape) == (1, 2048, 11264)


def test_mla_matches_the_reference_with_qk_wider_than_v():
    cfg = _cfg()
    assert cfg.mla.qk_nope_head_dim + cfg.mla.qk_rope_head_dim != cfg.mla.v_head_dim
    p = {k: v.detach().clone().requires_grad_()
         for k, v in _first(_params(cfg)["blocks"]["attn"]).items()}
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator().manual_seed(3),
                    requires_grad=True)
    pos = torch.arange(40)[None].expand(2, 40)
    got = Mla.mla_forward(p, x, pos, cfg)
    want = R.mla(p, x, R.dims_from_arch(cfg))
    _close(got, want)
    gg = torch.autograd.grad(got.square().sum(), [x, *p.values()])
    gw = torch.autograd.grad(want.square().sum(), [x, *p.values()])
    for a, b in zip(gg, gw):
        _close(a, b)


def test_rope_turns_interleaved_pairs():
    x = torch.randn(1, 5, 2, 8)
    pos = torch.arange(5)[None]
    got = Mla.rope_interleaved(x, pos, 50000.0)
    _close(got, R.rope(x[0], pos[0], 50000.0)[None], 1e-6)
    # pair (x0, x1) at position 1 turns by exactly 1 radian
    x = torch.zeros(1, 2, 1, 8)
    x[..., 0] = 1.0
    out = Mla.rope_interleaved(x, torch.arange(2)[None], 50000.0)
    assert torch.allclose(out[0, 1, 0, :2], torch.tensor([torch.cos(torch.tensor(1.0)),
                                                           torch.sin(torch.tensor(1.0))]))


def test_router_choices_and_weights_with_bias_renormalisation_and_scale():
    cfg = _cfg()
    p = _first(_params(cfg)["blocks"]["moe"])
    x2 = torch.randn(64, cfg.d_model, generator=torch.Generator().manual_seed(4))
    scores, idx, w = Moe.route_topk(p["router"], p["bias"], x2, cfg.moe)
    rs, ri, rw = R.route(p, x2, R.dims_from_arch(cfg))
    _close(scores, rs)
    assert torch.equal(idx.sort(-1).values, ri.sort(-1).values)
    order_g, order_r = idx.argsort(-1), ri.argsort(-1)
    _close(w.gather(-1, order_g), rw.gather(-1, order_r))
    assert torch.allclose(w.sum(-1), torch.full((64,), cfg.moe.routed_scale))
    # the bias selects: a large bias on expert 5 puts it in every token's
    # choice, but its weight is its unbiased score's share
    bias = torch.zeros(cfg.moe.n_experts)
    bias[5] = 10.0
    s2, i2, w2 = Moe.route_topk(p["router"], bias, x2, cfg.moe)
    assert bool((i2 == 5).any(-1).all())
    pick = torch.gather(s2, -1, i2)
    _close(w2, pick / pick.sum(-1, keepdim=True) * cfg.moe.routed_scale, 1e-6)


def test_dropless_path_keeps_every_pair_under_a_skewed_batch():
    """Every token picks the same 3 experts (a router that favours them),
    far past any GShard capacity (T K cf / E = 15 rows an expert): the
    layer computes all 3 x T pairs and equals the reference."""
    cfg = _cfg(expert_share=(0, 4))
    p = _first(_params(cfg)["blocks"]["moe"])
    p["bias"] = torch.zeros(cfg.moe.n_experts)
    p["bias"][[0, 2, 3]] = 5.0
    x = torch.randn(2, 20, cfg.d_model, generator=torch.Generator().manual_seed(5))
    rec = SpanRecorder()
    stats = Moe.StepStats(rec, keep_routes=True)
    y, aux = Moe.dsmoe_forward(p, x, cfg, stats=stats)
    counts = rec.snapshot()["counts"]
    assert counts["lm.moe.local_rows"] == 3 * 40
    assert counts["lm.moe.max_local_rows"] == 40
    assert torch.equal(stats.loads[0], torch.tensor([40, 0, 40, 40, 0, 0, 0, 0]))
    ry, raux = R.moe(p, x, R.dims_from_arch(cfg), None, 0)
    _close(y, ry)
    _close(aux, raux)


def test_bias_update_follows_the_load():
    bias = torch.zeros(2, 4)
    loads = torch.tensor([[10, 2, 6, 6], [3, 3, 3, 3]])
    out = Moe.update_bias(bias, loads, 1e-3)
    assert torch.equal(out, torch.tensor([[-1e-3, 1e-3, 0.0, 0.0], [0.0] * 4]))


def test_the_shares_add_up_to_the_whole_layer():
    """8 devices of 2 experts each: their outputs, with the shared experts
    (which every device computes alike) counted once, add up to the uncut
    reference's layer over all 16 experts; the routers' choices agree."""
    cfg = _cfg()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, n_experts=16))
    whole = _first(_params(cfg)["blocks"]["moe"])
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator().manual_seed(6))
    want, _ = R.moe(whole, x, R.dims_from_arch(cfg), None, 0)
    total, shared = torch.zeros_like(x), None
    for dev in range(8):
        share = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, expert_share=(2 * dev, 2)))
        p = dict(whole, **{k: whole[k][2 * dev: 2 * dev + 2] for k in ("w1", "w2", "w3")})
        y, _ = Moe.dsmoe_forward(p, x, share)
        total = total + y
        shared = Moe.mlp_forward(whole["shared"], x.reshape(-1, cfg.d_model),
                                 "swiglu").view_as(x)
    _close(total - 7 * shared, want)


def test_forward_loss_and_every_gradient_against_the_reference():
    cfg = _cfg(expert_share=(2, 4))
    params, batch = _params(cfg), _batch(cfg)
    d = R.dims_from_arch(cfg)
    logits, aux = forward_train(params, cfg, batch)
    _close(logits, R.logits(params, d, batch["tokens"]))
    loss, grads = loss_and_grads(params, cfg, batch)
    want, wgrads = R.loss_and_grads(params, d, batch)
    _close(loss, want)
    _close(loss_fn(params, cfg, batch), want)
    got = {".".join(p): g for (p, _), g in zip(
        sorted(leaves_with_paths(params)), grads)}
    assert set(got) == set(wgrads) | {"blocks.moe.bias"}
    assert float(got["blocks.moe.bias"].abs().max()) == 0.0
    for path, g in wgrads.items():
        _close(got[path], g)


def test_recomputation_changes_nothing():
    cfg = _cfg()
    params, batch = _params(cfg), _batch(cfg)
    l0, g0 = loss_and_grads(params, cfg, batch)
    l1, g1 = loss_and_grads(params, dataclasses.replace(cfg, remat=True), batch)
    _close(l1, l0, 1e-6)
    for a, b in zip(g1, g0):
        _close(a, b, 1e-6)


def test_train_step_against_the_reference_step():
    """One ``make_train_step`` step (Adam, the clip, the bias step) against
    the reference's first step, from the same parameters and batch."""
    cfg = _cfg(expert_share=(0, 4))
    params, batch = _params(cfg), _batch(cfg)
    want = {k: v.clone() for k, v in leaves_with_paths(params)}
    tree = {}
    for path, v in want.items():
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = v
    before = {k: v.clone() for k, v in leaves_with_paths(params)}   # the step consumes params
    step, opt = make_train_step(cfg)
    stats = Moe.StepStats(keep_routes=True)
    new, state, loss = step(params, opt.init(params), batch, stats)
    ref = R.reference_steps(tree, R.dims_from_arch(cfg), [batch], lr=1e-4, clip=1.0,
                            b1=0.9, b2=0.999, eps=1e-8)
    assert abs(float(loss) - ref["loss1"]) <= TOL * abs(ref["loss1"])
    assert R.route_mismatch(torch.stack([stats.routes[i] for i in sorted(stats.routes)]),
                            ref["routes1"], cfg.moe.n_experts) == 0.0
    assert torch.equal(new["blocks"]["moe"]["bias"], ref["bias"])
    for path, leaf in leaves_with_paths(new):
        node = tree
        for part in path:
            node = node[part]
        # Adam's first update is lr g / (|g| + eps): held to 1e-2 x lr, as an
        # element whose gradient is within summation noise (~1e-9 here) of
        # zero moves by an uncertain share of lr on either side
        assert float((leaf - node).abs().max()) <= 1e-2 * 1e-4, path
        if path[-1] != "bias":
            assert not torch.equal(leaf, before[path]), path


def test_decode_and_the_sharding_plan_say_plainly_they_are_missing():
    cfg = _cfg()
    with pytest.raises(NotImplementedError, match="latent cache"):
        init_cache(cfg, 1, 8, device="cpu")
    with pytest.raises(NotImplementedError, match="latent cache"):
        serve_step(_params(cfg), cfg, {"pos": 0}, torch.zeros(1, 1, dtype=torch.long))
    with pytest.raises(NotImplementedError, match="sharding plan"):
        param_pspecs(cfg)


def test_the_launcher_trains_the_reduced_config(capsys):
    from repro_torch.launch.train import main
    main(["--mode", "lm", "--arch", ARCH, "--reduced", "--steps", "3",
          "--batch", "2", "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out.strip().splitlines()
    final = json.loads(out[-1])
    assert final["steps"] == 3 and final["final_loss"] == final["final_loss"]
    assert out[0].startswith("[step    1] loss")


def test_the_benchmark_copy_of_the_reference_gives_the_same_numbers():
    """``perfbench/reference/moonlight.py`` (which imports nothing of the
    port) and the suite's reference follow the same step to the same bits."""
    from perfbench.reference import moonlight as B
    cfg = _cfg(expert_share=(2, 4))
    batch = _batch(cfg)
    d = R.dims_from_arch(cfg)
    assert dataclasses.asdict(d) == dataclasses.asdict(B.Dims(**dataclasses.asdict(d)))
    outs = []
    for mod in (R, B):
        tree = _params(cfg)
        outs.append((mod.reference_steps(tree, mod.Dims(**dataclasses.asdict(d)),
                                         [batch, _batch(cfg, seed=1)], lr=1e-4,
                                         clip=1.0, b1=0.9, b2=0.999, eps=1e-8), tree))
    (a, ta), (b, tb) = outs
    assert a["loss1"] == b["loss1"] and a["grad_norms"] == b["grad_norms"]
    assert torch.equal(a["routes1"], b["routes1"]) and torch.equal(a["bias"], b["bias"])
    for (pa, x), (pb, y) in zip(sorted(leaves_with_paths(ta)), sorted(leaves_with_paths(tb))):
        assert pa == pb and torch.equal(x, y)
