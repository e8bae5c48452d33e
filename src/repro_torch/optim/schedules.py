"""Port of ``repro.optim.schedules``: learning-rate schedules, each a
function from the int32 step tensor to an f32 learning-rate tensor on the
step's device, as ``optim.adam`` takes them."""

from __future__ import annotations

import math

import torch


def _lr(lr: float, step: torch.Tensor) -> torch.Tensor:
    return torch.tensor(lr, dtype=torch.float32, device=step.device)


def constant(lr: float):
    return lambda step: _lr(lr, step)


def exponential_decay(lr: float, decay_rate: float, decay_steps: int):
    def f(step):
        return _lr(lr, step) * decay_rate ** (step.to(torch.float32) / decay_steps)
    return f


def cosine_decay(lr: float, total_steps: int, final_fraction: float = 0.1):
    def f(step):
        t = torch.clamp(step.to(torch.float32) / total_steps, 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * t))
        return _lr(lr, step) * (final_fraction + (1 - final_fraction) * cos)
    return f


def linear_warmup_cosine(lr: float, warmup_steps: int, total_steps: int,
                         final_fraction: float = 0.1):
    cos = cosine_decay(lr, max(total_steps - warmup_steps, 1), final_fraction)

    def f(step):
        s = step.to(torch.float32)
        warm = _lr(lr, step) * s / max(warmup_steps, 1)
        return torch.where(step < warmup_steps, warm, cos(step - warmup_steps))
    return f
