"""The LM step's in-place Adam (``Optimizer.update_in_place``,
``kernels/leaf_adam``) on the CPU, where the wrapper runs its plain version.

The plain step is ``optim/adam.py``'s ``update`` followed by
``apply_updates``, written back where the leaves lie a slice at a time, so
it is held to those functions bit for bit: over mixed bf16 and f32 leaves of
odd sizes, a leaf above ``_CHUNK``, the clip biting and idle, a zero
gradient, weight decay and three consecutive steps.  The kernel's own norm
(``norm_f64``) is held to ``global_norm`` within a few f32 ulps, and to its
bits where every partial sum is exact.  Then ``make_train_step``'s contract:
the step consumes its trees and hands back the same tensors, three steps
equal the functional step (``update`` + ``apply_updates``) from cloned
inputs, ``lm.adam.fused`` counts one a step, and an optimizer without the
in-place step (``sgd``), or moments of another type, takes the functional
path as before.
"""

import dataclasses

import pytest
import torch

from repro_torch.checkpoint.checkpoint import tree_leaves
from repro_torch.configs import get_config
from repro_torch.core.spans import SpanRecorder
from repro_torch.kernels.leaf_adam import leaf_adam
from repro_torch.kernels.leaf_adam.ops import _check
from repro_torch.kernels.leaf_adam.ref import leaf_adam_ref, norm_f64
from repro_torch.launch.steps import make_train_step, with_leaves
from repro_torch.models import init_params
from repro_torch.optim.adam import (_CHUNK, Optimizer, adam, apply_updates,
                                    global_norm, sgd, step_scalars)

BF, F32 = torch.bfloat16, torch.float32
ODD = ((7, 3), (1,), (1000,), (5, 13, 3), (4099,), (2, 2, 2, 2, 3))


def _leaves(shapes, dtypes, seed, g_scale):
    g = torch.Generator().manual_seed(seed)
    rnd = lambda s, k: (k * torch.randn(s, generator=g))
    params = [rnd(s, 1.0).to(d) for s, d in zip(shapes, dtypes)]
    grads = [rnd(s, g_scale).to(d) for s, d in zip(shapes, dtypes)]
    return params, grads


def _steps_equal(opt, params, grads_per_step):
    """Both steps from clones of ``params`` and fresh moments; True where
    parameters, moments and counts agree bit for bit after every step."""
    pa, pb = [p.clone() for p in params], [p.clone() for p in params]
    sa, sb = opt.init(pa), opt.init(pb)
    for grads in grads_per_step:
        updates, sa = opt.update(grads, sa, pa)
        pa = apply_updates(pa, updates)
        mu, nu = sb.mu, sb.nu
        sb = opt.update_in_place(grads, sb, pb)
        assert sb.mu is mu and sb.nu is nu
        if not (int(sa.step) == int(sb.step) and all(
                torch.equal(a, b) for a, b in zip(pa + sa.mu + sa.nu,
                                                  pb + sb.mu + sb.nu))):
            return False
    return True


CASES = {
    # name: shapes, dtypes, gradient scale, clip, weight decay
    "mixed_clip_biting": (ODD, (BF, F32, BF, F32, BF, BF), 1.0, 1.0, 0.0),
    "mixed_clip_idle": (ODD, (BF, F32, BF, F32, BF, BF), 1e-3, 1.0, 0.0),
    "no_clip": (ODD, (F32, BF, F32, BF, F32, F32), 0.3, None, 0.0),
    "weight_decay": (ODD, (BF, F32, BF, F32, BF, BF), 1.0, 1.0, 0.01),
    "above_chunk": (((_CHUNK + 37,), (33,)), (BF, F32), 1.0, 1.0, 0.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_step_is_update_then_apply(case):
    shapes, dtypes, g_scale, clip, wd = CASES[case]
    opt = adam(1e-3, clip_norm=clip, weight_decay=wd, mu_dtype=F32)
    params, _ = _leaves(shapes, dtypes, 0, g_scale)
    grads = [_leaves(shapes, dtypes, 1 + t, g_scale)[1] for t in range(3)]
    if case == "mixed_clip_biting":
        grads[1][2].zero_()                    # one leaf's gradient is zero
        assert float(global_norm(grads[0])) > clip
    if case == "mixed_clip_idle":
        assert float(global_norm(grads[0])) < clip
    assert _steps_equal(opt, params, grads)


def test_plain_step_on_a_zero_gradient():
    """Every gradient zero: the norm is 0, the scale 1 (not clip / 1e-12),
    the moments stay 0 and a parameter moves by -0."""
    opt = adam(1e-3, clip_norm=1.0, mu_dtype=F32)
    params, grads = _leaves(ODD, (BF, F32) * 3, 0, 1.0)
    zeros = [torch.zeros_like(g) for g in grads]
    assert _steps_equal(opt, params, [zeros] * 3)


def test_the_wrapper_runs_the_plain_version_off_the_card():
    params, grads = _leaves(ODD, (BF, F32) * 3, 2, 1.0)
    g = torch.Generator().manual_seed(4)
    mu = [torch.rand(p.shape, generator=g) for p in params]
    nu = [torch.rand(p.shape, generator=g) for p in params]
    step, lr_t, bc1, bc2 = step_scalars(torch.tensor(4, dtype=torch.int32),
                                        lambda s: torch.tensor(1e-3), 0.9, 0.999)
    hp = dict(lr_t=lr_t, bc1=bc1, bc2=bc2, b1=0.9, b2=0.999, eps=1e-8, clip=1.0)
    a = [[t.clone() for t in ts] for ts in (params, mu, nu)]
    b = [[t.clone() for t in ts] for ts in (params, mu, nu)]
    before = leaf_adam.launches
    leaf_adam(a[0], grads, a[1], a[2], **hp)
    leaf_adam_ref(b[0], grads, b[1], b[2], **hp)
    assert leaf_adam.launches == before
    assert all(torch.equal(x, y) for xs, ys in zip(a, b) for x, y in zip(xs, ys))
    assert not any(torch.equal(x, y) for x, y in zip(a[0], params)
                   if x.dtype == F32)              # lr 1e-3 moves every f32 leaf


def test_the_plain_step_refuses_a_strided_leaf():
    p = torch.zeros(4, 6)[:, ::2]
    one = torch.ones(())
    with pytest.raises(ValueError, match="contiguous"):
        leaf_adam_ref([p], [torch.zeros(4, 3)], [torch.zeros(4, 3)],
                      [torch.zeros(4, 3)], lr_t=one, bc1=one, bc2=one, b1=0.9,
                      b2=0.999, eps=1e-8, clip=None)


@pytest.mark.parametrize("bad", ["mixed_types", "f16", "moments_bf16", "strided",
                                 "shape", "scalar"])
def test_the_launch_checks_refuse_what_the_kernel_does_not_take(bad):
    p, g = torch.zeros(4, 6, dtype=BF), torch.zeros(4, 6, dtype=BF)
    m, v = torch.zeros(4, 6), torch.zeros(4, 6)
    one = torch.ones((), dtype=F32)
    scalars = (one, one, one)
    if bad == "mixed_types":
        g = g.float()
    elif bad == "f16":
        p, g = p.half(), g.half()
    elif bad == "moments_bf16":
        m = m.to(BF)
    elif bad == "strided":
        m = torch.zeros(6, 4).t()
    elif bad == "shape":
        v = torch.zeros(24)
    else:
        scalars = (one, one.double(), one)
    with pytest.raises(ValueError):
        _check([p], [g], [m], [v], scalars)
    _check([torch.zeros(4, 6, dtype=BF)], [torch.zeros(4, 6, dtype=BF)],
           [torch.zeros(4, 6)], [torch.zeros(4, 6)], (one, one, one))


def test_the_kernels_norm_against_global_norm():
    """``norm_f64`` (the kernel's) is within 4 f32 ulps of ``global_norm``
    on random leaves, and equal to it where every sum of squares is exact
    in f32 (gradients of a few bits): there the plain step with either norm
    gives the same bits with the clip biting."""
    shapes, dtypes = ODD, (BF, F32, BF, F32, BF, BF)
    for seed in range(8):
        _, grads = _leaves(shapes, dtypes, seed, 1.0)
        a, b = float(global_norm(grads)), float(norm_f64(grads))
        assert abs(a - b) <= 4 * 2.0 ** -23 * b, (seed, a, b)
    g = torch.Generator().manual_seed(9)
    exact = [(torch.randint(-3, 4, s, generator=g) * 2.0 ** -6).to(d)
             for s, d in zip(shapes, dtypes)]
    assert torch.equal(global_norm(exact), norm_f64(exact))
    assert float(global_norm(exact)) > 1.0
    params, _ = _leaves(shapes, dtypes, 3, 1.0)
    step, lr_t, bc1, bc2 = step_scalars(torch.tensor(0, dtype=torch.int32),
                                        lambda s: torch.tensor(1e-3), 0.9, 0.999)
    outs = []
    for norm in (global_norm, norm_f64):
        p = [t.clone() for t in params]
        m = [torch.zeros(t.shape) for t in params]
        v = [torch.zeros(t.shape) for t in params]
        leaf_adam_ref(p, exact, m, v, lr_t=lr_t, bc1=bc1, bc2=bc2, b1=0.9,
                      b2=0.999, eps=1e-8, clip=1.0, norm=norm)
        outs.append(p + m + v)
    assert all(torch.equal(x, y) for x, y in zip(*outs))
    assert float(norm_f64([])) == 0.0


# ------------------------------------------------------------------ #
# make_train_step: the donated, in-place step
# ------------------------------------------------------------------ #
def _moonlight():
    """moonlight's reduced config at 3 layers (1 dense + 2 MoE), bf16
    weights beside its f32 norms, router and bias."""
    cfg = get_config("moonlight-16b-a3b").reduced()
    cfg = dataclasses.replace(cfg, n_layers=3, d_model=64, d_ff=32, vocab=128,
                              dtype="bfloat16")
    return dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_experts=8, top_k=3, dense_d_ff=48))


def _dense():
    return dataclasses.replace(get_config("stablelm-1.6b").reduced(), dtype="bfloat16")


def _batches(cfg, n, B=2, S=24):
    g = torch.Generator().manual_seed(5)
    out = []
    for _ in range(n):
        ids = torch.randint(1, cfg.vocab, (B, S + 1), generator=g)
        out.append({"tokens": ids[:, :-1], "labels": ids[:, 1:],
                    "mask": torch.ones(B, S)})
    return out


def _functional(opt: Optimizer) -> Optimizer:
    """``opt`` without its in-place step: the step takes ``update`` and
    ``apply_updates``, as it did before the in-place step existed."""
    return Optimizer(init=opt.init, update=opt.update)


def _clone(tree):
    return with_leaves(tree, [t.clone() for t in tree_leaves(tree)])


@pytest.mark.parametrize("mb", [1, 2])
@pytest.mark.parametrize("arch", ["moonlight", "dense"])
def test_train_step_is_in_place_and_equals_the_functional_step(arch, mb):
    cfg = _moonlight() if arch == "moonlight" else _dense()
    params = init_params(cfg, 0, device="cpu")
    ref_params = _clone(params)
    rec = SpanRecorder()
    base = adam(1e-3, clip_norm=1.0, mu_dtype=F32)
    step, opt = make_train_step(cfg, base, microbatches=mb, recorder=rec)
    ref_step, ref_opt = make_train_step(cfg, _functional(base), microbatches=mb)
    state, ref_state = opt.init(params), ref_opt.init(ref_params)
    kinds = {t.dtype for t in tree_leaves(params)}
    assert kinds == ({BF, F32} if arch == "moonlight" else {BF})
    for batch in _batches(cfg, 3):
        leaves, mu, nu = tree_leaves(params), state.mu, state.nu
        new, state, loss = step(params, state, batch)
        assert all(a is b for a, b in zip(tree_leaves(new), leaves))
        assert state.mu is mu and state.nu is nu
        params = new
        ref_params, ref_state, ref_loss = ref_step(ref_params, ref_state, batch)
        assert torch.equal(loss, ref_loss)
        assert int(state.step) == int(ref_state.step)
        for a, b in zip(tree_leaves(params) + state.mu + state.nu,
                        tree_leaves(ref_params) + ref_state.mu + ref_state.nu):
            assert torch.equal(a, b)
    counts = rec.snapshot()["counts"]
    assert counts["lm.adam.fused"] == counts["lm.steps"] == 3


@pytest.mark.parametrize("which", ["sgd", "bf16_moments"])
def test_train_step_keeps_the_functional_path_without_the_in_place_step(which):
    """``sgd`` has no in-place step and Adam's bf16 moments are not the
    kernel's: both take ``update`` + ``apply_updates`` (new leaves) and
    count no ``lm.adam.fused``; their bits are those of the update applied
    by hand from cloned inputs."""
    cfg = _dense()
    params = init_params(cfg, 0, device="cpu")
    optimizer = (sgd(1e-2, momentum=0.9, clip_norm=1.0) if which == "sgd"
                 else adam(1e-3, clip_norm=1.0))
    rec = SpanRecorder()
    step, opt = make_train_step(cfg, optimizer, recorder=rec)
    state = opt.init(params)
    want_params, want_state = _clone(params), opt.init(params)
    from repro_torch.launch.steps import loss_and_grads
    for batch in _batches(cfg, 2):
        _, grads = loss_and_grads(want_params, cfg, batch)
        leaves = tree_leaves(want_params)
        updates, want_state = optimizer.update(grads, want_state, leaves)
        want_params = with_leaves(want_params, apply_updates(leaves, updates))
        old = tree_leaves(params)
        params, state, _ = step(params, state, batch)
        assert not any(a is b for a, b in zip(tree_leaves(params), old))
        for a, b in zip(tree_leaves(params) + state.mu,
                        tree_leaves(want_params) + want_state.mu):
            assert torch.equal(a, b)
    assert "lm.adam.fused" not in rec.snapshot()["counts"]
    assert rec.snapshot()["counts"]["lm.steps"] == 2
