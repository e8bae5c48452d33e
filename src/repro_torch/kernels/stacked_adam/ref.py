"""Plain PyTorch version of ``stacked_adam``: one Adam step of many
workers at once over stacked ``[W, ...]`` leaves.

What the wrapper runs for CPU tensors, and what the kernel is held against
on the card.  Row ``w`` of every leaf belongs to worker ``w``: its gradient
is clipped by its own global norm and its own int32 step counts its bias
corrections.  The elementwise arithmetic is ``optim/adam.py``'s, op for
op, so for the same gradients and clip scale a row comes out bit for bit
as ``adam(...).update`` and ``apply_updates`` give it.  Two things are
pinned down beyond a per-worker call:

* each row's sum of squares is taken in float64 and rounded to float32
  after the square root, so the norm does not depend on the order of the
  sum (the kernel sums in another order than PyTorch); ``optim/adam.py``
  sums in float32, so where the clip bites the two scales may differ in
  the last bit;
* each distinct step's bias corrections come from the 0-dim ``torch.pow``
  that a per-worker call makes: the CPU's vectorized ``pow`` over a
  ``[W]`` tensor can differ from it by an ulp.
"""

from __future__ import annotations

from typing import Sequence

import torch

F32 = torch.float32


def _col(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``[W]`` as ``[W, 1, ...]`` against a ``[W, ...]`` leaf."""
    return x.view((-1,) + (1,) * (like.dim() - 1))


def row_scale(grads: Sequence[torch.Tensor], clip: float) -> torch.Tensor:
    """``[W]`` f32 clip scales ``min(1, clip / (norm + 1e-12))``, ``norm``
    the square root of a row's sum of squares over every leaf."""
    sq = sum(g.double().square().sum(dim=tuple(range(1, g.dim())))
             for g in grads)
    norm = sq.sqrt().to(F32)
    return torch.clamp(clip / (norm + 1e-12), max=1.0)


def bias_corrections(step: torch.Tensor, b1: float, b2: float
                     ) -> tuple[torch.Tensor, torch.Tensor]:
    """``(1 - b1^step, 1 - b2^step)`` per row in f32, each distinct step
    through the 0-dim ``pow`` of ``optim/adam.py``."""
    uniq, inv = torch.unique(step, return_inverse=True)
    out = []
    for b in (b1, b2):
        base = torch.tensor(b, dtype=F32, device=step.device)
        out.append(torch.stack([1.0 - torch.pow(base, s.to(F32))
                                for s in uniq])[inv])
    return out[0], out[1]


@torch.no_grad()
def stacked_adam_ref(params: Sequence[torch.Tensor],
                     grads: Sequence[torch.Tensor],
                     mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                     step: torch.Tensor, *, lr: float, b1: float, b2: float,
                     eps: float, clip: float) -> None:
    """One Adam step of every row, in place: ``step += 1``, then each
    leaf's ``mu``, ``nu`` and ``params``.  A gradient may be a ``[W, ...]``
    view with row stride 0 (every row steps on the same gradient)."""
    scale = row_scale(grads, clip)
    step.add_(1)
    bc1, bc2 = bias_corrections(step, b1, b2)
    for p, g, m, v in zip(params, grads, mu, nu):
        g32 = g * _col(scale, p)
        m_new = b1 * m + (1 - b1) * g32
        v_new = b2 * v + (1 - b2) * torch.square(g32)
        m_hat = m_new / _col(bc1, p)
        v_hat = v_new / _col(bc2, p)
        delta = m_hat / (torch.sqrt(v_hat) + eps)
        p.add_(-lr * delta)
        m.copy_(m_new)
        v.copy_(v_new)
