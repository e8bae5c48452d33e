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
gradients, as in JAX).  The qnet family's double-DQN train step needs
``configs/damoldqn.py`` and comes with ROADMAP A7; its serve step takes a
``QNetwork``.
"""

from __future__ import annotations

import torch

from repro_torch.checkpoint.checkpoint import tree_leaves
from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M
from repro_torch.optim.adam import Optimizer, adam, apply_updates


def make_optimizer(cfg: ArchConfig, lr: float = 1e-4) -> Optimizer:
    # Adam(1e-4) is the paper's optimizer (Table 3); mu/nu in f32 for bf16
    # params to keep moments stable.
    return adam(lr, clip_norm=1.0, mu_dtype=torch.float32)


def with_leaves(tree: dict, leaves) -> dict:
    """``tree`` with its leaves replaced, in ``tree_leaves`` order, by
    ``leaves``; the keys keep their order."""
    it = iter(leaves)

    def walk(t):
        if not isinstance(t, dict):
            return next(it)
        out = {k: walk(t[k]) for k in sorted(t)}
        return {k: out[k] for k in t}
    return walk(tree)


def loss_and_grads(params: dict, cfg: ArchConfig,
                   batch: dict) -> tuple[torch.Tensor, list[torch.Tensor]]:
    """``M.loss_fn`` and its gradient, one tensor per leaf in
    ``tree_leaves`` order (``jax.value_and_grad(loss_fn)``).  A leaf the
    loss does not reach gets zeros, as in JAX."""
    leaves = [t.detach().requires_grad_() for t in tree_leaves(params)]
    with torch.enable_grad():
        loss = M.loss_fn(with_leaves(params, leaves), cfg, batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, leaves)]
    return loss.detach(), grads


def _split(batch: dict, mb: int) -> list[dict]:
    """``mb`` microbatches of ``batch`` along its leading dim, in order."""
    return [{k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
             for k, v in batch.items()} for i in range(mb)]


def make_train_step(cfg: ArchConfig, optimizer: Optimizer | None = None,
                    microbatches: int = 1):
    """-> ``(train_step, opt)``; ``train_step(params, opt_state, batch) ->
    (params, opt_state, loss)`` with ``opt_state = opt.init(params)``.

    With ``microbatches > 1`` the batch splits into that many microbatches,
    one backward each; the gradients accumulate in each parameter's type,
    ``(a + g).to(a.dtype)``, and the step takes ``(g / mb)`` in the
    parameter's type and reports the mean of the microbatch losses, as the
    reference's ``lax.scan`` does."""
    if cfg.family == "qnet":
        raise NotImplementedError(
            "the qnet family's train step needs configs/damoldqn.py, which is "
            "not ported yet (ROADMAP A7); the DQN learner is "
            "repro_torch.core.distributed")
    base = optimizer or make_optimizer(cfg)
    opt = Optimizer(init=lambda params: base.init(tree_leaves(params)),
                    update=base.update)
    mb = max(microbatches, 1)

    def train_step(params, opt_state, batch):
        leaves = tree_leaves(params)
        if mb == 1:
            loss, grads = loss_and_grads(params, cfg, batch)
        else:
            loss = torch.zeros((), dtype=torch.float32, device=leaves[0].device)
            grads = [torch.zeros_like(p) for p in leaves]
            for mbatch in _split(batch, mb):
                part, g = loss_and_grads(params, cfg, mbatch)
                loss = loss + part
                grads = [(a + b).to(a.dtype) for a, b in zip(grads, g)]
            grads = [(g / mb).to(p.dtype) for g, p in zip(grads, leaves)]
            loss = loss / mb
        updates, opt_state = base.update(grads, opt_state, leaves)
        return with_leaves(params, apply_updates(leaves, updates)), opt_state, loss

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
        def qnet_serve_step(net, states: torch.Tensor) -> torch.Tensor:
            return net(states)
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
