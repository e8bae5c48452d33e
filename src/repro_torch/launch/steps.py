"""Port of ``repro.launch.steps``: the serve and prefill step functions.

``make_serve_step(cfg)`` -> f(params, cache, tokens) -> (logits, cache);
``make_prefill_step(cfg)`` -> f(params, batch) -> logits.  The qnet family
(the paper's own model) serves Q-values from a ``QNetwork``.  PyTorch runs
eagerly, so these are the functions themselves, with no ``jit``.
``make_train_step`` comes with the LM training slice (ROADMAP).
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.models import model as M


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
