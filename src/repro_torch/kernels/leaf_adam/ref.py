"""Plain PyTorch version of ``leaf_adam``: one Adam step over a list of
leaves, in place.

What the wrapper runs for tensors off the card, and what the kernel is held
against on the card.  It is ``optim/adam.py``'s ``update`` followed by
``apply_updates``, with that module's own arithmetic (``adam_leaf``) a
slice of ``_CHUNK`` elements at a time, each slice's results written back
where the slice lies: so on any device it gives those functions' bits,
without a second set of moments or parameters beside the first.

The clip's norm is ``norm(grads)``: by default ``optim/adam.py``'s
``global_norm`` (f32 sums leaf by leaf, in PyTorch's order), which keeps the
functional step's bits; the kernel's own norm is ``norm_f64``, a sum of
squares in f64 rounded to f32 after the square root, which the order of
the sum does not move beyond the last bit.  The two can differ in the last
bits of the norm (and above a norm of ~1.8e19, where the f32 sum of squares
overflows to inf and the f64 one does not), so the card's check hands
``norm_f64`` to this function.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.optim.adam import _CHUNK, adam_leaf, clip_scale, global_norm


def norm_f64(grads: Sequence[torch.Tensor]) -> torch.Tensor:
    """The kernel's norm: sqrt of the f64 sum of every element's square, as
    f32 (0 for no leaves); a slice at a time, as the step."""
    sq = torch.zeros((), dtype=torch.float64,
                     device=grads[0].device if grads else None)
    for g in grads:
        flat = g.reshape(-1)
        for lo in range(0, flat.numel(), _CHUNK):
            sq = sq + flat[lo:lo + _CHUNK].double().square().sum()
    return sq.sqrt().to(torch.float32)


@torch.no_grad()
def leaf_adam_ref(params: Sequence[torch.Tensor], grads: Sequence[torch.Tensor],
                  mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor], *,
                  lr_t: torch.Tensor, bc1: torch.Tensor, bc2: torch.Tensor,
                  b1: float, b2: float, eps: float, clip: float | None,
                  weight_decay: float = 0.0,
                  norm: Callable[[Sequence[torch.Tensor]], torch.Tensor] = global_norm
                  ) -> None:
    """One Adam step of every leaf, in place (``params``, ``mu`` and ``nu``
    contiguous)."""
    for k, t in enumerate((*params, *mu, *nu)):
        if not t.is_contiguous():
            raise ValueError(f"leaf_adam writes in place: tensor {k} of params, "
                             f"mu and nu must be contiguous")
    scale = None if clip is None else clip_scale(norm(grads), clip)
    hp = dict(scale=scale, lr_t=lr_t, bc1=bc1, bc2=bc2, b1=b1, b2=b2, eps=eps,
              weight_decay=weight_decay)
    for p, g, m, v in zip(params, grads, mu, nu):
        flat = [t.reshape(-1) for t in (p, g, m, v)]
        for lo in range(0, p.numel(), _CHUNK):
            ps, gs, ms, vs = (t[lo:lo + _CHUNK] for t in flat)
            u, m_new, v_new = adam_leaf(gs, ms, vs, ps, **hp)
            ps.copy_((ps + u).to(ps.dtype))
            ms.copy_(m_new)
            vs.copy_(v_new)
