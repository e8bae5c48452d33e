"""The port's LM training slice against the JAX reference, on the CPU, at
the reduced configs in f32.

Parameters are the reference's own ``init_params`` trees carried over as
numpy (``params_from_numpy``); batches come from both packages' SMILES
pipelines or from numpy with a seed.  Tolerances (the ``lm_train`` phase
of ``chip_smoke.py`` holds the card to the CPU the same way):

* the tokenizer and the batches are bit-identical;
* ``loss_fn`` within 1e-5 relative, every gradient leaf within 1e-4 of
  that leaf's max |g| (measured: <= 6.1e-6);
* 3 train steps: losses within 1e-4 relative, and the updates within
  1e-3 x lr wherever the reference's gradient exceeds 1e-3 of its leaf's
  max (Adam's first steps are ~lr x sign(g), so where |g| is near 0 the
  sign, and so the update, is noise in both packages);
* remat on and off, bit-identical.

The LM kernels are forward only: with grad enabled and an input that
requires grad, both wrappers raise on the CPU as on the card.
"""

import dataclasses
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.chem.smiles import canonical_smiles as jax_canonical_smiles
from repro.configs import get_config as jax_get_config
from repro.data.datasets import antioxidant_dataset as jax_antioxidant_dataset
from repro.data.pipeline import lm_batches_from_smiles as jax_lm_batches
from repro.data.tokenizer import SmilesTokenizer as JaxTokenizer
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.models import init_params as jax_init_params
from repro.models.model import loss_fn as jax_loss_fn
from repro.optim import adam as jax_adam
from repro.optim import schedules as jax_schedules
from repro_torch.chem.smiles import canonical_smiles
from repro_torch.checkpoint.checkpoint import tree_leaves
from repro_torch.configs import get_config
from repro_torch.data import SmilesTokenizer, antioxidant_dataset, lm_batches_from_smiles
from repro_torch.examples import backbone_lm
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.ssd_scan.ops import ssd_scan
from repro_torch.kernels.ssd_scan.ref import ssd_ref
from repro_torch.launch.steps import loss_and_grads, make_train_step, pick_microbatches
from repro_torch.launch.train import lm_batches, lm_loop
from repro_torch.models import forward_train, loss_fn, params_from_numpy
from repro_torch.models.layers import _attn_block, gqa_attention
from repro_torch.optim import adam, schedules

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ["stablelm-1.6b", "zamba2-1.2b", "mamba2-2.7b"]
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-4             # of the leaf's max |g|
STEP_LOSS_RTOL = 1e-4
UPDATE_TOL = 1e-3           # x lr, where |g_ref| > UPDATE_MASK x the leaf's max
UPDATE_MASK = 1e-3
LR = 1e-4


def _cfgs(arch, **changes):
    ref = dataclasses.replace(jax_get_config(arch).reduced(), **changes)
    return ref, dataclasses.replace(get_config(arch).reduced(), **changes)


def _ref_params(cfg, seed=1):
    return jax.tree_util.tree_map(np.asarray, jax_init_params(cfg, jax.random.PRNGKey(seed)))


def _batch(vocab, B, S, seed=0):
    """Random tokens, next-token labels, a mask with ~10% zeros."""
    rng = np.random.default_rng(seed)
    tokens = rng.integers(1, vocab, (B, S)).astype(np.int32)
    labels = np.concatenate([tokens[:, 1:], np.zeros((B, 1), np.int32)], axis=1)
    mask = (rng.random((B, S)) > 0.1).astype(np.float32)
    return {"tokens": tokens, "labels": labels, "mask": mask}


def _jnp(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _ref_value_and_grad(params, cfg, batch):
    loss, grads = jax.jit(jax.value_and_grad(jax_loss_fn), static_argnums=1)(
        params, cfg, _jnp(batch))
    return float(loss), [np.asarray(g) for g in jax.tree_util.tree_leaves(grads)]


def _assert_grads_close(got, want):
    assert len(got) == len(want)
    for i, (g, r) in enumerate(zip(got, want)):
        assert g.shape == r.shape and g.dtype == torch.float32, i
        scale = max(float(np.abs(r).max()), 1e-30)
        np.testing.assert_allclose(g.numpy(), r, atol=GRAD_TOL * scale, rtol=0,
                                   err_msg=f"leaf {i}")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Small CPU tensors: one intra-op thread is as fast alone, and far
    faster beside other test processes on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def corpus():
    port = [canonical_smiles(m) for m in antioxidant_dataset(256)]
    ref = [jax_canonical_smiles(m) for m in jax_antioxidant_dataset(256)]
    return port, ref


# ------------------------------------------------------------------ #
# data and schedules
# ------------------------------------------------------------------ #
def test_tokenizer_matches_the_reference(corpus):
    port, ref = corpus
    assert port == ref
    tok, jtok = SmilesTokenizer(), JaxTokenizer()
    assert tok.vocab == jtok.vocab and tok.vocab_size == jtok.vocab_size
    for s in port + ["C[Si]c1ccccc1O", ""]:
        for kw in ({}, {"max_len": 16}, {"add_special": False}):
            a, b = tok.encode(s, **kw), jtok.encode(s, **kw)
            assert a.dtype == b.dtype and np.array_equal(a, b), (s, kw)
            assert tok.decode(a) == jtok.decode(b)


@pytest.mark.parametrize("batch,seq,seed", [(8, 64, 0), (3, 16, 7)])
def test_lm_batches_are_the_references_bit_for_bit(corpus, batch, seq, seed):
    port, ref = corpus
    mine = lm_batches_from_smiles(port, SmilesTokenizer(), batch, seq, seed=seed)
    theirs = jax_lm_batches(ref, JaxTokenizer(), batch, seq, seed=seed)
    for _ in range(5):
        a, b = next(mine), next(theirs)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("name,args", [
    ("constant", (3e-4,)),
    ("exponential_decay", (1e-3, 0.5, 7)),
    ("cosine_decay", (1e-3, 15, 0.1)),
    ("linear_warmup_cosine", (1e-3, 5, 18, 0.2)),
])
def test_schedules_match_the_reference(name, args):
    steps = np.arange(21, dtype=np.int32)
    want = np.array([float(getattr(jax_schedules, name)(*args)(jnp.asarray(s)))
                     for s in steps])
    f = getattr(schedules, name)(*args)
    got = [f(torch.tensor(s, dtype=torch.int32)) for s in steps]
    assert all(g.dtype == torch.float32 and g.dim() == 0 for g in got)
    np.testing.assert_allclose(np.array([float(g) for g in got]), want,
                               rtol=1e-6, atol=0)


def test_pick_microbatches_matches_the_reference():
    from repro.configs import INPUT_SHAPES as JAX_SHAPES
    from repro.launch.steps import pick_microbatches as jax_pick
    from repro_torch.configs import INPUT_SHAPES
    for arch in ARCHS:
        for name in INPUT_SHAPES:
            for dp in (1, 4, 16):
                assert pick_microbatches(get_config(arch), INPUT_SHAPES[name], dp) == \
                    jax_pick(jax_get_config(arch), JAX_SHAPES[name], dp)


# ------------------------------------------------------------------ #
# loss_fn and its gradients
# ------------------------------------------------------------------ #
LOSS_CASES = [(a, B, S, {}) for a in ARCHS for B, S in ((2, 32), (1, 1024))] + [
    # three applications of zamba2's shared block: its gradient is the sum
    ("zamba2-1.2b", 2, 32, {"n_layers": 6}),
]


@pytest.mark.parametrize("arch,B,S,changes", LOSS_CASES,
                         ids=[f"{a}-S{S}" + ("-6layers" if c else "")
                              for a, _, S, c in LOSS_CASES])
def test_loss_and_grads_match_the_reference(arch, B, S, changes):
    ref_cfg, cfg = _cfgs(arch, **changes)
    params = _ref_params(ref_cfg)
    batch = _batch(cfg.vocab, B, S)
    want_loss, want_grads = _ref_value_and_grad(params, ref_cfg, batch)
    loss, grads = loss_and_grads(params_from_numpy(params, device="cpu"), cfg, batch)
    assert loss.dtype == torch.float32 and loss.dim() == 0
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(grads, want_grads)
    # the forward alone, no grad, gives the same loss bits
    with torch.no_grad():
        assert torch.equal(loss_fn(params_from_numpy(params, device="cpu"), cfg, batch),
                           loss)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "mamba2-2.7b"])
def test_ssm_gradients_are_finite_at_the_published_chunk(arch):
    """At the configs' SSD chunk of 256 the decay above a chunk's diagonal
    overflows f32, and the reference's ``where(causal, exp(decay), 0)``
    backpropagates 0 x inf = NaN into every SSM leaf (so the reference is
    run at chunk 64 here, where it stays finite); the port masks before
    the exp.  Its chunk-256 loss and gradients match the reference's
    chunk-64 ones: the same function, summed over other chunks."""
    ref_cfg, cfg = _cfgs(arch)
    ref_cfg = dataclasses.replace(ref_cfg, ssm=dataclasses.replace(ref_cfg.ssm, chunk=64))
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(cfg.ssm, chunk=256))
    params = _ref_params(ref_cfg)
    batch = _batch(cfg.vocab, 1, 512)
    want_loss, want_grads = _ref_value_and_grad(params, ref_cfg, batch)
    assert all(np.isfinite(g).all() for g in want_grads)
    loss, grads = loss_and_grads(params_from_numpy(params, device="cpu"), cfg, batch)
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    np.testing.assert_allclose(float(loss), want_loss, rtol=LOSS_RTOL)
    _assert_grads_close(grads, want_grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_on_and_off_are_bit_identical(arch):
    _, cfg = _cfgs(arch)
    assert not cfg.remat and get_config(arch).remat
    params = params_from_numpy(_ref_params(_cfgs(arch)[0]), device="cpu")
    batch = _batch(cfg.vocab, 1, 512, seed=3)
    off = loss_and_grads(params, cfg, batch)
    on = loss_and_grads(params, dataclasses.replace(cfg, remat=True), batch)
    assert torch.equal(on[0], off[0])
    assert all(torch.equal(a, b) for a, b in zip(on[1], off[1]))


def test_attention_blocks_are_checkpointed_under_grad():
    """At Sq = 2 x q_block the backward holds no block's scores (only the
    blocks' inputs are saved), and gives the bits of the unchecked blocks."""
    g = torch.Generator().manual_seed(0)
    B, S, H, K, D, qb = 1, 256, 4, 2, 16, 128
    q, k, v = (torch.randn((B, S, n, D), generator=g).requires_grad_()
               for n in (H, K, K))
    saved = []

    def pack(t):
        saved.append(t.numel())
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = gqa_attention(q, k, v, causal=True, q_block=qb)
    assert max(saved) < B * H * qb * S          # one block's f32 scores
    out.square().sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    want = torch.cat([_attn_block(q[:, i:i + qb], k, v, None, causal=True,
                                  window=None, prefix_len=0, q_start=i)
                      for i in range(0, S, qb)], dim=1)
    assert torch.equal(out, want)
    want.square().sum().backward()
    assert all(torch.equal(a, t.grad) for a, t in zip(got, (q, k, v)))
    with torch.no_grad():
        assert torch.equal(gqa_attention(q, k, v, causal=True, q_block=qb), out)


# ------------------------------------------------------------------ #
# the train step
# ------------------------------------------------------------------ #
def _adam_view(state):
    """(step, mu, nu) of either package's Adam state as f32 numpy lists."""
    as_np = (lambda t: t.numpy()) if isinstance(state.mu, list) else np.asarray
    mu = state.mu if isinstance(state.mu, list) else jax.tree_util.tree_leaves(state.mu)
    nu = state.nu if isinstance(state.nu, list) else jax.tree_util.tree_leaves(state.nu)
    return int(state.step), [as_np(m) for m in mu], [as_np(v) for v in nu]


def _updates(view):
    """Adam's update of the step that produced ``view``, from its moments:
    ``-lr m_hat / (sqrt(v_hat) + eps)``, the same f32 numpy for both
    packages.  (Held through the parameters instead, a difference far
    below 1e-3 x lr can still round ``p + u`` one ulp apart.)"""
    step, mu, nu = view
    bc1, bc2 = np.float32(1 - 0.9 ** step), np.float32(1 - 0.999 ** step)
    return [-np.float32(LR) * (m / bc1) / (np.sqrt(v / bc2) + np.float32(1e-8))
            for m, v in zip(mu, nu)]


@pytest.mark.parametrize("mb,clip", [(1, True), (2, False)],
                         ids=["mb1", "mb2-noclip"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_the_reference(arch, mb, clip):
    """3 steps from the reference's parameters: losses, the first moments
    (within 1e-4 of each leaf's max: Adam's update alone would not see a
    wrong gradient scale), and the updates wherever the reference's
    (clipped) gradient, read back from its first moment, exceeds 1e-3 of
    its leaf's max.  Without the clip (an ``optimizer`` passed in) the
    gradient's scale reaches the moments: a clip at norm 1 hides it."""
    ref_cfg, cfg = _cfgs(arch)
    ref_params = _ref_params(ref_cfg)
    jstep, jopt = jax_make_train_step(
        ref_cfg, microbatches=mb,
        optimizer=None if clip else jax_adam(LR, mu_dtype=jnp.float32))
    jstep = jax.jit(jstep)
    jp = jax.tree_util.tree_map(jnp.asarray, ref_params)
    jstate = jopt.init(jp)
    step, opt = make_train_step(
        cfg, microbatches=mb,
        optimizer=None if clip else adam(LR, mu_dtype=torch.float32))
    params = params_from_numpy(ref_params, device="cpu")
    state = opt.init(params)
    batches = lm_batches_from_smiles(
        ["CC(C)c1ccc(O)cc1", "Oc1ccccc1", "CCOC(=O)C=Cc1ccc(O)c(OC)c1",
         "Oc1ccc(N)cc1C", "COc1cc(C=O)ccc1O", "CC(=O)Nc1ccc(O)cc1"],
        SmilesTokenizer(), 4, 32, seed=mb)
    ref_mu = _adam_view(jstate)[1]
    for t in range(3):
        batch = next(batches)
        jp, jstate, jloss = jstep(jp, jstate, _jnp(batch))
        new, state, loss = step(params, state, batch)
        assert all(a.dtype == b.dtype and a.shape == b.shape
                   for a, b in zip(tree_leaves(params), tree_leaves(new)))
        params = new
        np.testing.assert_allclose(float(loss), float(jloss), rtol=STEP_LOSS_RTOL)
        ref_view, view = _adam_view(jstate), _adam_view(state)
        assert ref_view[0] == view[0] == t + 1
        for got, want in zip(view[1], ref_view[1]):     # the clipped gradients' scale
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=GRAD_TOL * float(np.abs(want).max()))
        for i, (g, want, got) in enumerate(zip(
                [(m - 0.9 * m0) / 0.1 for m, m0 in zip(ref_view[1], ref_mu)],
                _updates(ref_view), _updates(view))):
            sel = np.abs(g) > UPDATE_MASK * np.abs(g).max()
            diff = np.abs(got - want)[sel]
            assert diff.size == 0 or diff.max() <= UPDATE_TOL * LR, (t, i, diff.max())
        ref_mu = ref_view[1]


def test_train_step_accumulates_in_the_parameter_type():
    """bf16 leaves get bf16 gradients and stay bf16; the f32 SSM leaves stay
    f32; the moments are f32 lists in tree_leaves order."""
    _, cfg = _cfgs("zamba2-1.2b", dtype="bfloat16")
    from repro_torch.models import init_params
    params = init_params(cfg, 0, device="cpu")
    batch = _batch(cfg.vocab, 2, 32)
    step, opt = make_train_step(cfg, microbatches=2)
    state = opt.init(params)
    assert all(m.dtype == torch.float32 for m in state.mu)
    new, state, loss = step(params, state, batch)
    _, grads = loss_and_grads(params, cfg, batch)
    for p, q, g in zip(tree_leaves(params), tree_leaves(new), grads):
        assert q.dtype == p.dtype == g.dtype
    assert new["blocks"]["ssm"]["A_log"].dtype == torch.float32
    assert torch.isfinite(loss) and list(new) == list(params)


def test_qnet_train_step_names_its_roadmap_item():
    """``make_train_step(damoldqn)`` is the double-DQN step: on the
    reference's ``tests/test_models.py::test_qnet_train_step`` batch (no
    legal next action) its loss equals the reference's within 1e-5
    relative (tests/test_torch_dryrun.py holds the step in full)."""
    ref_cfg, cfg = jax_get_config("damoldqn"), get_config("damoldqn")
    params = jax.tree_util.tree_map(np.asarray, jax_init_params(ref_cfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    batch = {"states": rng.random((8, 2049)).astype(np.float32),
             "rewards": rng.random(8).astype(np.float32),
             "dones": np.ones(8, np.float32),
             "next_fps": np.zeros((8, 4, 2049), np.float32),
             "next_mask": np.zeros((8, 4), np.float32)}
    jstep, jopt = jax_make_train_step(ref_cfg)
    _, _, want = jax.jit(jstep)(params, params, jopt.init(params), batch)
    step, opt = make_train_step(cfg)
    tp = params_from_numpy(params, device="cpu")
    new, state, loss = step(tp, tp, opt.init(tp), batch)
    np.testing.assert_allclose(float(loss), float(want), rtol=LOSS_RTOL)
    assert int(state.step) == 1 and len(state.mu) == 10
    assert [l["w"].shape for l in new["layers"]] == [l["w"].shape for l in tp["layers"]]


# ------------------------------------------------------------------ #
# the launcher and the example twin
# ------------------------------------------------------------------ #
def test_launcher_loop_matches_the_reference_from_its_parameters(corpus):
    """The first 10 losses of ``--mode lm --reduced`` at its defaults
    (stablelm-1.6b, B 8, S 64), both loops from the reference's init."""
    ref_cfg, cfg = _cfgs("stablelm-1.6b")
    params = jax_init_params(ref_cfg, jax.random.PRNGKey(0))
    jstep, jopt = jax_make_train_step(ref_cfg)
    jstep = jax.jit(jstep)
    jstate = jopt.init(params)
    want = []
    for _, batch in zip(range(10), jax_lm_batches(corpus[1], JaxTokenizer(), 8, 64)):
        params, jstate, loss = jstep(params, jstate, _jnp(batch))
        want.append(float(loss))
    start = params_from_numpy(jax.tree_util.tree_map(
        np.asarray, jax_init_params(ref_cfg, jax.random.PRNGKey(0))), device="cpu")
    out = io.StringIO()
    with redirect_stdout(out):
        got = lm_loop(cfg, start, lm_batches(8, 64), 10)
    np.testing.assert_allclose(got, want, rtol=STEP_LOSS_RTOL)
    assert got[-1] < got[0]
    assert out.getvalue().splitlines()[0].startswith("[step    1] loss")


def test_launcher_lm_mode_runs_on_the_cpu_and_defaults_to_cuda():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--mode", "lm",
           "--reduced", "--steps", "3", "--batch", "2", "--seq", "16"]
    res = subprocess.run(cmd + ["--device", "cpu"], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    last = json.loads(res.stdout.strip().splitlines()[-1])
    assert last["steps"] == 3 and np.isfinite(last["final_loss"])
    if not torch.cuda.is_available():
        res = subprocess.run(cmd, env=env, cwd=ROOT, capture_output=True,
                             text=True, timeout=300)
        assert res.returncode != 0 and "no CUDA device" in res.stderr
        assert "final_loss" not in res.stdout


def test_backbone_lm_twin_lowers_the_loss():
    assert backbone_lm.parser().parse_args([]).device == "cuda"
    out = io.StringIO()
    with redirect_stdout(out):
        backbone_lm.main(["--device", "cpu", "--steps", "8", "--batch", "4",
                          "--seq", "32", "--arch", "mamba2-2.7b"])
    first, last = out.getvalue().splitlines()[-1].split(" in ")[0].split()[1::2]
    assert float(last) < float(first)


# ------------------------------------------------------------------ #
# the LM kernels are forward only
# ------------------------------------------------------------------ #
def _kernel_case(name):
    g = torch.Generator().manual_seed(5)
    if name == "flash_attention":
        q, k, v = (torch.randn((2, 16, n, 32), generator=g) for n in (4, 2, 2))
        return (flash_attention, (q, k, v), {"causal": True},
                lambda q, k, v: attention_ref(q.transpose(1, 2), k.transpose(1, 2),
                                              v.transpose(1, 2), causal=True)
                .transpose(1, 2))
    x = torch.randn((1, 32, 4, 16), generator=g)
    dt = torch.rand((1, 32, 4), generator=g) * 0.5
    A = torch.rand((4,), generator=g) + 0.5
    Bm, Cm = (torch.randn((1, 32, 1, 16), generator=g) for _ in range(2))
    return ssd_scan, (x, dt, A, Bm, Cm), {"chunk": 8}, ssd_ref


@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan"])
def test_kernel_refuses_grad_before_it_runs(name):
    fn, args, kw, _ = _kernel_case(name)
    for i in range(len(args)):
        grad_args = [a.clone().requires_grad_(j == i) for j, a in enumerate(args)]
        launches = fn.launches
        with pytest.raises(RuntimeError, match="forward only.*use_pallas=False"):
            fn(*grad_args, **kw)
        assert fn.launches == launches


@pytest.mark.parametrize("name", ["flash_attention", "ssd_scan"])
def test_kernel_forward_without_grad_is_unchanged(name):
    fn, args, kw, plain = _kernel_case(name)
    want = plain(*args)
    want = want if isinstance(want, tuple) else (want,)
    with torch.no_grad():       # inputs that require grad, grad disabled
        got = fn(*[a.clone().requires_grad_() for a in args], **kw)
    got_plain = fn(*args, **kw)  # grad enabled, no input requires it
    for out in (got, got_plain):
        out = out if isinstance(out, tuple) else (out,)
        assert all(torch.equal(a, b) for a, b in zip(out, want))


@pytest.mark.parametrize("arch", ARCHS)
def test_use_pallas_loss_refuses_grad_and_no_grad_forward_runs(arch):
    ref_cfg, cfg = _cfgs(arch)
    kcfg = dataclasses.replace(cfg, use_pallas=True)
    params = params_from_numpy(_ref_params(ref_cfg), device="cpu")
    batch = _batch(cfg.vocab, 2, 32)
    with pytest.raises(RuntimeError, match="forward only"):
        loss_and_grads(params, kcfg, batch)
    trainable = {k: v for k, v in params.items()}
    trainable["embed"] = params["embed"].clone().requires_grad_()
    with torch.no_grad():
        got, _ = forward_train(trainable, kcfg, batch)
        want, _ = forward_train(params, kcfg, batch)
    assert torch.equal(got, want)
