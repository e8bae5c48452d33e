"""Port of ``repro.core.agent`` (the Q-network part): the MolDQN MLP.

``QNetwork`` is an ``nn.Module`` over fingerprint states: the candidate
next state's Morgan fingerprint (radius 3, 2048 bits) concatenated with a
steps-left feature, through hidden sizes [1024, 512, 128, 32] to one Q
value.  Its weights keep the JAX layout, ``w: [in, out]`` and
``b: [out]``, so a parameter tree of ``repro.core.agent.QNetwork`` crosses
over as it is (``params_from_jax`` / ``params_to_numpy``, no transpose),
and the hand-written ``fused_qnet`` kernel reads ``w`` with the same
strides.

``DQNAgent``, ``huber`` and the stacked (per-worker) applies arrive with
the training slice of the port.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.chem.fingerprint import FP_BITS
from repro_torch.device import resolve_device

HIDDEN_SIZES = (1024, 512, 128, 32)
STATE_DIM = FP_BITS + 1  # fingerprint ++ steps-left


class QNetwork(nn.Module):
    """MLP over fingerprint states, ``x [..., in_dim] -> q [...]``.

    Initialised like the reference (He-normal weights, zero biases) from
    ``generator``, or holding the given ``layers``; the numbers differ
    from ``jax.random``'s, so parity tests carry the reference's own
    parameters over instead.  ``device=None`` is the GPU."""

    def __init__(self, hidden: Sequence[int] = HIDDEN_SIZES,
                 in_dim: int = STATE_DIM, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None,
                 layers: Sequence[tuple[torch.Tensor, torch.Tensor]] | None = None):
        super().__init__()
        device = resolve_device(device)
        self.hidden = tuple(int(h) for h in hidden)
        self.in_dim = int(in_dim)
        sizes = (self.in_dim,) + self.hidden + (1,)
        if layers is None:
            layers = [(torch.randn(i, o, generator=generator) * (2.0 / i) ** 0.5,
                       torch.zeros(o)) for i, o in zip(sizes[:-1], sizes[1:])]
        shapes = [(tuple(w.shape), tuple(b.shape)) for w, b in layers]
        if shapes != [((i, o), (o,)) for i, o in zip(sizes[:-1], sizes[1:])]:
            raise ValueError(f"layer shapes {shapes} do not fit sizes {sizes}")
        self.w = nn.ParameterList(
            [nn.Parameter(w.to(device, torch.float32), requires_grad=False)
             for w, _ in layers])
        self.b = nn.ParameterList(
            [nn.Parameter(b.to(device, torch.float32), requires_grad=False)
             for _, b in layers])

    def layers(self) -> list[tuple[torch.Tensor, torch.Tensor]]:
        """``[(w [in, out], b [out]), ...]`` in forward order."""
        return list(zip(self.w, self.b))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = x
        n = len(self.w)
        for li, (w, b) in enumerate(self.layers()):
            h = h @ w + b
            if li < n - 1:
                h = torch.relu(h)
        return h[..., 0]


def params_from_jax(params: dict, *,
                    device: str | torch.device | None = None) -> QNetwork:
    """A ``QNetwork`` holding the reference's parameter tree
    ``{"layers": [{"w": [in, out], "b": [out]}, ...]}`` (numpy or any
    array ``np.array`` takes).  Values are copied bit for bit and NOT
    transposed: the port keeps the ``[in, out]`` layout."""
    layers = [(torch.from_numpy(np.array(l["w"], np.float32)),
               torch.from_numpy(np.array(l["b"], np.float32)))
              for l in params["layers"]]
    return QNetwork(hidden=[w.shape[1] for w, _ in layers[:-1]],
                    in_dim=layers[0][0].shape[0], device=device, layers=layers)


def params_to_numpy(net: QNetwork) -> dict:
    """The inverse of ``params_from_jax``: the reference's tree layout."""
    return {"layers": [{"w": w.detach().cpu().numpy(),
                        "b": b.detach().cpu().numpy()}
                       for w, b in net.layers()]}


def pad_rows(n: int, sizes=(64, 128, 256, 512, 1024, 2048, 4096)) -> int:
    """Row-count padding bucket for per-worker Q dispatches."""
    for s in sizes:
        if n <= s:
            return s
    return ((n + 4095) // 4096) * 4096


def candidate_capacity_table(n_workers: int, max_candidates: int = 1024,
                             *, grain: int = 32) -> tuple[int, ...]:
    """Padded candidate-axis capacities for the dense ``[W, C, D]`` fleet
    Q batch: 2x rungs up to W=64, 1.5x up to W=256, 1.25x beyond.  With a
    sticky high-water buffer (capacity only ever grows) the batch shape
    changes O(log C) times per run."""
    ratio = 2.0 if n_workers <= 64 else 1.5 if n_workers <= 256 else 1.25
    caps, c = [], grain
    while c < max_candidates:
        caps.append(c)
        c = max(c + grain, grain * round(c * ratio / grain))
    caps.append(c)
    return tuple(caps)


def candidate_capacity(n: int, table: tuple[int, ...]) -> int:
    """Smallest rung >= n (grain-rounded past the table's end)."""
    for cap in table:
        if n <= cap:
            return cap
    return 32 * -(-n // 32)
