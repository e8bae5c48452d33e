"""Port of ``repro.launch.steps``: the train, serve and prefill step
functions.

``make_train_step(cfg)`` -> (f(params, opt_state, batch) -> (params,
opt_state, loss), opt); ``make_serve_step(cfg)`` -> f(params, cache,
tokens) -> (logits, cache); ``make_prefill_step(cfg)`` -> f(params, batch)
-> logits.  PyTorch runs eagerly, so these are the functions themselves,
with no ``jit``.

The train step flattens the nested-dict parameter tree in
``jax.tree_util`` leaf order (sorted keys, ``checkpoint.tree_leaves``), so
the optimizer's moments and the clip's global norm run over the leaves in
the reference's order; ``opt.init`` takes the tree, as the reference's
does, and keeps the moments as lists in that order.  Gradients come from
``torch.autograd.grad`` and keep each leaf's type (bf16 leaves get bf16
gradients, as in JAX).

The LM train step consumes its ``params`` and ``opt_state``, as the
reference's donates them (``donate_argnums=(0, 1)``): Adam with f32 moments
steps every leaf in place (``Optimizer.update_in_place``: one
``kernels/leaf_adam`` launch on the card, its plain version elsewhere), so
the step holds one set of parameters and moments, and the returned trees
hold the tensors passed in.

The mla_moe family's step also moves each MoE layer's selection bias
after Adam, outside autograd and in place, from the loads its forward
counted (``models.moe.update_bias``, DeepSeek-V3 §2.1.2); with a
``recorder`` (``core.spans.SpanRecorder``) its forward's parts are spanned
(``lm.mla``, ``lm.moe.route`` / ``.experts`` / ``.combine`` / ``.shared``),
the step's ``lm.backward`` and ``lm.adam``, and counted (``lm.steps``,
``lm.tokens``, ``lm.moe.local_rows``, ``lm.moe.max_local_rows``,
``lm.adam.fused``).

The qnet family (``damoldqn``) builds the double-DQN step instead, over the
parameter tree ``{"layers": [{"w", "b"}, ...]}``: ``make_train_step`` ->
f(params, target_params, opt_state, batch) -> (params, opt_state, loss),
the loss ``core.agent.dqn_loss`` (plain ``qnet_ref`` under autograd: the Q
kernels are forward only) and Adam over the leaves in the same order;
``make_serve_step`` -> f(params, states [..., 2049]) -> q [...], every row
in one ``fused_qnet`` call (the CUDA kernel on the card, ``qnet_ref`` on
the CPU), as the reference's ``use_pallas_qnet`` routes it.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.checkpoint import tree_leaves
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.models.moe import StepStats, update_bias
from repro_torch.optim.adam import Optimizer, adam, apply_updates


def make_optimizer(cfg: ArchConfig, lr: float = 1e-4) -> Optimizer:
    # Adam(1e-4) is the paper's optimizer (Table 3); mu/nu in f32 for bf16
    # params to keep moments stable.
    return adam(lr, clip_norm=1.0, mu_dtype=torch.float32)


def with_leaves(tree: dict, leaves) -> dict:
    """``tree`` (dicts and lists) with its leaves replaced, in
    ``tree_leaves`` order, by ``leaves``; the keys keep their order."""
    it = iter(leaves)

    def walk(t):
        if isinstance(t, list):
            return [walk(v) for v in t]
        if not isinstance(t, dict):
            return next(it)
        out = {k: walk(t[k]) for k in sorted(t)}
        return {k: out[k] for k in t}
    return walk(tree)


def _qnet_layers(params: dict) -> list[tuple[torch.Tensor, torch.Tensor]]:
    return [(l["w"], l["b"]) for l in params["layers"]]


def _make_qnet_train_step(opt: Optimizer):
    """The reference's double-DQN step (``repro/launch/steps.py:30-48``):
    the online net's argmax over the legal next actions (``-inf`` masked),
    the target net's value there, 0 for rows with no legal action, Huber on
    ``q_sa - (r + (1 - d) v)``; discount 1.0 multiplies exactly."""
    from repro_torch.core.agent import dqn_loss

    def qnet_train_step(params, target_params, opt_state, batch):
        leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
        device = leaves[0].device
        dev = {k: torch.as_tensor(v, device=device) for k, v in batch.items()}
        with torch.enable_grad():
            loss, _ = dqn_loss(_qnet_layers(with_leaves(params, leaves)),
                               _qnet_layers(target_params), dev, 1.0)
            grads = torch.autograd.grad(loss, leaves)
        params_in = [t.detach() for t in leaves]
        updates, opt_state = opt.update(list(grads), opt_state, params_in)
        return (with_leaves(params, apply_updates(params_in, updates)), opt_state,
                loss.detach())
    return qnet_train_step


def loss_and_grads(params: dict, cfg: ArchConfig, batch: dict, *,
                   stats: StepStats | None = None
                   ) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """``M.loss_fn`` and its gradient, one tensor per leaf in
    ``tree_leaves`` order (``jax.value_and_grad(loss_fn)``).  A leaf the
    loss does not reach gets zeros, as in JAX."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    stats = stats or StepStats()
    with torch.enable_grad():
        loss = M.loss_fn(with_leaves(params, leaves), cfg, batch, stats=stats)
        with stats.span("lm.backward"):
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), grads


def _split(batch: dict, mb: int) -> list[dict]:
    """``mb`` microbatches of ``batch`` along its leading dim, in order."""
    return [{k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(mb)]


def _move_bias(params: dict, cfg: ArchConfig, loads: list[torch.Tensor]) -> None:
    """Move ``blocks.moe.bias`` [L, E] in place by the step's loads (one
    ``[E]`` per MoE layer, summed over microbatches)."""
    bias = params["blocks"]["moe"]["bias"]
    bias.copy_(update_bias(bias, torch.stack(loads), cfg.moe.bias_rate))


def make_train_step(cfg: ArchConfig, optimizer: Optimizer | None = None,
                    microbatches: int = 1, recorder=None):
    """-> ``(train_step, opt)``; ``train_step(params, opt_state, batch,
    stats=None) -> (params, opt_state, loss)`` with ``opt_state =
    opt.init(params)``.  ``stats`` (a ``models.moe.StepStats``, mla_moe
    only) receives the step's router loads, and its choices if it keeps
    them; its recorder is ``recorder``.

    The step consumes ``params`` and ``opt_state``, on every device (the
    reference's ``donate_argnums=(0, 1)``): where the optimizer has
    ``update_in_place`` and the moments are f32, the returned trees hold
    the same tensors, written in place, and the step counts
    ``lm.adam.fused``; otherwise (``sgd``, moments of another type) Adam's
    ``update`` and ``apply_updates`` return new leaves, and the selection
    bias still moves in place.  A caller that compares with the state
    before a step clones it first.  ``opt.init`` on CUDA parameters starts
    the ``leaf_adam`` build in the background.

    With ``microbatches > 1`` the batch splits into that many microbatches,
    one backward each; the gradients accumulate in each parameter's type,
    ``(a + g).to(a.dtype)``, and the step takes ``(g / mb)`` in the
    parameter's type and reports the mean of the microbatch losses, as the
    reference's ``lax.scan`` does.

    For the qnet family the step is ``qnet_train_step(params,
    target_params, opt_state, batch)`` over the replay batch (``states``,
    ``rewards``, ``dones``, ``next_fps``, ``next_mask``)."""
    base = optimizer or make_optimizer(cfg)
    if cfg.family == "qnet":
        return _make_qnet_train_step(base), Optimizer(
            init=lambda params: base.init(tree_leaves(params)), update=base.update)

    def init(params):
        leaves = tree_leaves(params)
        if base.update_in_place is not None and leaves and leaves[0].is_cuda:
            from repro_torch.kernels.leaf_adam import build as leaf_adam_build
            leaf_adam_build.nvcc_build().start()    # nvcc runs while the step warms
        return base.init(leaves)

    opt = Optimizer(init=init, update=base.update,
                    update_in_place=base.update_in_place)
    mb = max(microbatches, 1)
    moving_bias = cfg.family == "mla_moe" and cfg.moe.bias_rate > 0

    def train_step(params, opt_state, batch, stats: StepStats | None = None):
        leaves = tree_leaves(params)
        if stats is None:
            stats = StepStats(recorder)
        elif stats.rec is None:
            stats.rec = recorder
        loads = None
        if mb == 1:
            loss, grads = loss_and_grads(params, cfg, batch, stats=stats)
            loads = [stats.loads[i] for i in sorted(stats.loads)]
        else:
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = [torch.zeros_like(p) for p in leaves]
            for mbatch in _split(batch, mb):
                part, g = loss_and_grads(params, cfg, mbatch, stats=stats)
                loss = loss + part
                grads = [(a + b).to(a.dtype) for a, b in zip(grads, g)]
                now = [stats.loads[i] for i in sorted(stats.loads)]
                loads = now if loads is None else [a + b for a, b in zip(loads, now)]
            grads = [(g / mb).to(p.dtype) for g, p in zip(grads, leaves)]
            loss = loss / mb
        with stats.span("lm.adam"):
            if base.update_in_place is not None and all(
                    m.dtype == torch.float32 for m in (*opt_state.mu, *opt_state.nu)):
                opt_state = base.update_in_place(grads, opt_state, leaves)
                stats.count("lm.adam.fused", 1)
            else:
                updates, opt_state = base.update(grads, opt_state, leaves)
                del grads
                params = with_leaves(params, apply_updates(leaves, updates))
        if moving_bias:
            _move_bias(params, cfg, loads)
        stats.count("lm.steps", 1)
        stats.count("lm.tokens", int(torch.as_tensor(batch["tokens"]).numel()))
        return params, opt_state, loss

    return train_step, opt


def pick_microbatches(cfg: ArchConfig, shape, dp: int, *, budget_gib: float = 4.0) -> int:
    """Smallest power-of-2 microbatch count keeping the per-chip rematted
    residual stack under ``budget_gib`` (with batch still divisible)."""
    if shape.kind != "train" or cfg.family == "qnet":
        return 1
    dtype_b = 2 if cfg.dtype == "bfloat16" else 4
    b_loc = max(shape.global_batch // dp, 1)
    stack = cfg.n_layers * b_loc * shape.seq_len * cfg.d_model * dtype_b
    mb = 1
    while (stack / mb) > budget_gib * 2**30 \
            and shape.global_batch % (2 * mb) == 0 \
            and (shape.global_batch // (2 * mb)) % dp == 0:
        mb *= 2
    return mb


def make_serve_step(cfg: ArchConfig):
    if cfg.family == "qnet":
        from repro_torch.kernels.fused_qnet.ops import fused_qnet

        def qnet_serve_step(params, states) -> torch.Tensor:
            layers = _qnet_layers(params)
            x = torch.as_tensor(states, dtype=torch.float32, device=layers[0][0].device)
            q = fused_qnet(layers, x.reshape(-1, x.shape[-1]).contiguous())
            return q.reshape(x.shape[:-1])
        return qnet_serve_step

    def serve_step(params, cache, tokens):
        return M.serve_step(params, cfg, cache, tokens)

    return serve_step


def make_prefill_step(cfg: ArchConfig):
    """Prefill = the forward pass producing logits (cache write omitted, as
    in the reference)."""
    def prefill_step(params, batch):
        logits, _ = M.forward_train(params, cfg, batch)
        return logits
    return prefill_step
