"""Port of ``repro.optim.adam``: Adam and SGD over lists of tensors, by
hand.

The paper trains every model with Adam(lr=1e-4) (Appendix C, Table 3).
The API mirrors the reference's:

    opt = adam(1e-4, clip_norm=10.0)
    state = opt.init(params)                     # params: list of tensors
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

and, beside it, Adam's step in place (f32 moments):

    state = opt.update_in_place(grads, state, params)   # params, mu, nu written

``torch.optim.Adam`` with ``clip_grad_norm_`` is not the same function, so
this module repeats the reference's formulas instead:

* the clip scale is ``min(1, max_norm / (norm + 1e-12))``, applied even
  when it is 1;
* the bias corrections use the step count cast to float32, and ``eps`` is
  added after ``sqrt(v_hat)``.

``step`` is an int32 tensor; the trainer keeps one per worker, stacked
``[W]`` like the reference's ``vmap(opt.init)``, and steps its stacked
workers with ``kernels/stacked_adam``, these formulas in this order of
operations.  ``update_in_place`` is ``update`` then ``apply_updates`` with
the parameters and moments written where they lie, as the reference's
donated train step has XLA do: ``kernels/leaf_adam`` (one fused pass over
every leaf on the card, its plain version, these formulas a slice at a
time, elsewhere); the LM train step takes it.  Nothing here records
autograd history.  The clip's scale is applied in the update's own loop,
and a leaf larger than ``_CHUNK`` elements is updated a slice at a time:
the same bits, with a slice's f32 temporaries (an LM's stacked expert
leaves run to 600 M elements).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, NamedTuple, Sequence

import torch

Schedule = Callable[[torch.Tensor], torch.Tensor]  # step -> lr

# elements of a leaf that Adam updates at a time (its f32 temporaries)
_CHUNK = 1 << 25


class OptState(NamedTuple):
    step: torch.Tensor          # int32, scalar (or [W] when stacked)
    mu: list[torch.Tensor]      # first moments, one per parameter
    nu: list[torch.Tensor]      # second moments, one per parameter


@dataclass(frozen=True)
class Optimizer:
    init: Callable[[Sequence[torch.Tensor]], OptState]
    update: Callable[[Sequence[torch.Tensor], OptState, Sequence[torch.Tensor]],
                     tuple[list[torch.Tensor], OptState]]
    # ``update`` + ``apply_updates`` in place: (grads, state, params) -> the
    # new state over the same moments; None where the optimizer has none
    update_in_place: Callable[[Sequence[torch.Tensor], OptState,
                               Sequence[torch.Tensor]], OptState] | None = None


def _as_schedule(lr: float | Schedule) -> Schedule:
    if callable(lr):
        return lr
    return lambda step: torch.tensor(lr, dtype=torch.float32, device=step.device)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum, in list order, of every tensor's sum of squares."""
    if not tensors:
        return torch.tensor(0.0)
    return torch.sqrt(sum(torch.sum(torch.square(x.to(torch.float32)))
                          for x in tensors))


def clip_scale(norm: torch.Tensor, max_norm: float) -> torch.Tensor:
    """The clip's scale ``min(1, max_norm / (norm + 1e-12))``."""
    return torch.clamp(max_norm / (norm + 1e-12), max=1.0)


@torch.no_grad()
def clip_by_global_norm(tensors: Sequence[torch.Tensor],
                        max_norm: float) -> list[torch.Tensor]:
    scale = clip_scale(global_norm(tensors), max_norm)
    return [(x * scale).to(x.dtype) for x in tensors]


def step_scalars(step: torch.Tensor, schedule: Schedule, b1: float, b2: float
                 ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The next step's count ``step + 1``, its learning rate and its f32
    bias corrections ``1 - b1^t``, ``1 - b2^t``, on ``step``'s device."""
    step = step + 1
    stepf = step.to(torch.float32)
    bc1 = 1.0 - torch.pow(torch.tensor(b1, dtype=torch.float32,
                                       device=step.device), stepf)
    bc2 = 1.0 - torch.pow(torch.tensor(b2, dtype=torch.float32,
                                       device=step.device), stepf)
    return step, schedule(step), bc1, bc2


def adam_leaf(g, m, v, p, *, scale, lr_t, bc1, bc2, b1: float, b2: float,
              eps: float, weight_decay: float):
    """One leaf's (or slice's) Adam arithmetic: -> (the update in ``p``'s
    type, the new ``m`` and ``v`` in their types); ``scale`` is the clip's
    (None: no clip)."""
    if scale is not None:
        g = (g * scale).to(g.dtype)
    g32 = g.to(torch.float32)
    m_new = b1 * m.to(torch.float32) + (1 - b1) * g32
    v_new = b2 * v.to(torch.float32) + (1 - b2) * torch.square(g32)
    del g32
    m_hat = m_new / bc1
    v_hat = v_new / bc2
    delta = m_hat / (torch.sqrt(v_hat) + eps)
    if weight_decay:
        delta = delta + weight_decay * p.to(torch.float32)
    return (-lr_t * delta).to(p.dtype), m_new.to(m.dtype), v_new.to(v.dtype)


def adam(
    lr: float | Schedule,
    b1: float = 0.9,
    b2: float = 0.999,
    eps: float = 1e-8,
    weight_decay: float = 0.0,
    clip_norm: float | None = None,
    mu_dtype: torch.dtype | None = None,
) -> Optimizer:
    """AdamW when weight_decay > 0, vanilla Adam otherwise."""
    schedule = _as_schedule(lr)

    def init(params: Sequence[torch.Tensor]) -> OptState:
        device = params[0].device if params else None
        zeros = lambda p: torch.zeros_like(p, dtype=mu_dtype or p.dtype)
        return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                        mu=[zeros(p) for p in params],
                        nu=[zeros(p) for p in params])

    @torch.no_grad()
    def update(grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]
               ) -> tuple[list[torch.Tensor], OptState]:
        # the clip's scale, applied leaf by leaf in the loop (the same bits
        # as clip_by_global_norm, without a second list of gradients)
        scale = None
        if clip_norm is not None:
            scale = clip_scale(global_norm(grads), clip_norm)
        step, lr_t, bc1, bc2 = step_scalars(state.step, schedule, b1, b2)
        hp = dict(scale=scale, lr_t=lr_t, bc1=bc1, bc2=bc2, b1=b1, b2=b2,
                  eps=eps, weight_decay=weight_decay)
        leaf = lambda g, m, v, p: adam_leaf(g, m, v, p, **hp)

        updates, mu, nu = [], [], []
        for g, m, v, p in zip(grads, state.mu, state.nu, params):
            if g.numel() <= _CHUNK:
                u, m_new, v_new = leaf(g, m, v, p)
            else:
                # every formula is elementwise, so a slice at a time gives
                # the same bits with a slice's f32 temporaries
                u, m_new, v_new = (torch.empty(t.shape, dtype=t.dtype, device=t.device)
                                   for t in (p, m, v))
                flat = [t.reshape(-1) for t in (g, m, v, p, u, m_new, v_new)]
                for lo in range(0, g.numel(), _CHUNK):
                    part = [t[lo:lo + _CHUNK] for t in flat]
                    for out, val in zip(part[4:], leaf(*part[:4])):
                        out.copy_(val)
            updates.append(u)
            mu.append(m_new)
            nu.append(v_new)
        return updates, OptState(step=step, mu=mu, nu=nu)

    @torch.no_grad()
    def update_in_place(grads: Sequence[torch.Tensor], state: OptState,
                        params: Sequence[torch.Tensor]) -> OptState:
        # imported here: kernels/leaf_adam's plain version imports this module
        from repro_torch.kernels.leaf_adam import leaf_adam
        step, lr_t, bc1, bc2 = step_scalars(state.step, schedule, b1, b2)
        leaf_adam(params, grads, state.mu, state.nu, lr_t=lr_t, bc1=bc1,
                  bc2=bc2, b1=b1, b2=b2, eps=eps, clip=clip_norm,
                  weight_decay=weight_decay)
        return OptState(step=step, mu=state.mu, nu=state.nu)

    return Optimizer(init=init, update=update, update_in_place=update_in_place)


def sgd(
    lr: float | Schedule,
    momentum: float = 0.0,
    nesterov: bool = False,
    clip_norm: float | None = None,
) -> Optimizer:
    """SGD with optional (Nesterov) momentum, the reference's: ``m <-
    momentum m + g`` in the parameter's type, the step ``-lr (g + momentum
    m)`` with Nesterov, else ``-lr m``; ``nu`` stays the zeros it starts as."""
    schedule = _as_schedule(lr)

    def init(params: Sequence[torch.Tensor]) -> OptState:
        device = params[0].device if params else None
        zeros = [torch.zeros_like(p) for p in params]
        return OptState(step=torch.zeros((), dtype=torch.int32, device=device),
                        mu=zeros, nu=zeros)

    @torch.no_grad()
    def update(grads: Sequence[torch.Tensor], state: OptState,
               params: Sequence[torch.Tensor]
               ) -> tuple[list[torch.Tensor], OptState]:
        if clip_norm is not None:
            grads = clip_by_global_norm(grads, clip_norm)
        step = state.step + 1
        lr_t = schedule(step)
        updates, mu = [], []
        for g, m in zip(grads, state.mu):
            m_new = momentum * m + g
            d = g + momentum * m_new if nesterov else m_new
            updates.append((-lr_t * d.to(torch.float32)).to(g.dtype))   # lr_t is f32, as in JAX
            mu.append(m_new)
        return updates, OptState(step=step, mu=mu, nu=state.nu)

    return Optimizer(init=init, update=update)


@torch.no_grad()
def apply_updates(params: Sequence[torch.Tensor],
                  updates: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    return [(p + u).to(p.dtype) for p, u in zip(params, updates)]
