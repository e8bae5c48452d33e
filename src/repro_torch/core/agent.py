"""Port of ``repro.core.agent``: the MolDQN MLP, the double-DQN loss and
the single-model agent.

``QNetwork`` is an ``nn.Module`` over fingerprint states: the candidate
next state's Morgan fingerprint (radius 3, 2048 bits) concatenated with a
steps-left feature, through hidden sizes [1024, 512, 128, 32] to one Q
value.  Its weights keep the JAX layout, ``w: [in, out]`` and
``b: [out]``, so a parameter tree of ``repro.core.agent.QNetwork`` crosses
over as it is (``params_from_jax`` / ``params_to_numpy``, no transpose),
and the hand-written kernels read ``w`` with the same strides.

Outside the module, parameters are "layers": a list of ``(w, b)`` tensor
pairs in forward order, or of ``(w [W, in, out], b [W, out])`` pairs for a
stacked fleet of W workers (``stacked_params_from_jax`` /
``stacked_params_to_numpy`` carry those, optimizer state included).  The
optimizer sees them flattened as ``[w0, b0, w1, b1, ...]``.

``DQNConfig.use_pallas_qnet`` is kept so configurations match the
reference's field for field; the port selects nothing with it, because on
the card the kernel is always the path.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch
from torch import nn

from repro_torch.chem.fingerprint import FP_BITS
from repro_torch.device import resolve_device
from repro_torch.kernels.fused_qnet.ops import fused_qnet
from repro_torch.kernels.fused_qnet.ref import qnet_ref
from repro_torch.optim.adam import OptState, adam, apply_updates

Layers = list[tuple[torch.Tensor, torch.Tensor]]

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


def apply_stacked(stacked: Sequence[tuple[torch.Tensor, torch.Tensor]],
                  x: torch.Tensor) -> torch.Tensor:
    """Per-worker parameter selection, plain: ``x [W, C, in]`` under
    ``stacked`` ``[(w [W, in, out], b [W, out])]`` -> q ``[W, C]``."""
    from repro_torch.kernels.packed_qnet.ref import stacked_qnet_ref
    return stacked_qnet_ref(x, stacked)


def apply_stacked_packed(stacked: Sequence[tuple[torch.Tensor, torch.Tensor]],
                         bits: torch.Tensor, frac: torch.Tensor) -> torch.Tensor:
    """``apply_stacked`` fed packed candidate fingerprints, plain: bits u8
    ``[W, C, FP_BITS/8]`` (MSB first), frac f32 ``[W, C]`` -> q ``[W, C]``."""
    from repro_torch.kernels.packed_qnet.ref import packed_qnet_stacked_ref
    return packed_qnet_stacked_ref(bits, frac, stacked)


def flat(layers: Sequence[tuple[torch.Tensor, torch.Tensor]]) -> list[torch.Tensor]:
    """``[(w0, b0), (w1, b1), ...]`` -> ``[w0, b0, w1, b1, ...]``."""
    return [t for wb in layers for t in wb]


def unflat(tensors: Sequence[torch.Tensor]) -> Layers:
    """The inverse of ``flat``."""
    return [(tensors[i], tensors[i + 1]) for i in range(0, len(tensors), 2)]


def _tree_to_flat(tree: dict, device: torch.device) -> list[torch.Tensor]:
    return [torch.from_numpy(np.array(l[k], np.float32)).to(device)
            for l in tree["layers"] for k in ("w", "b")]


def _flat_to_tree(tensors: Sequence[torch.Tensor]) -> dict:
    return {"layers": [{"w": w.detach().cpu().numpy(), "b": b.detach().cpu().numpy()}
                       for w, b in unflat(list(tensors))]}


def stacked_params_from_jax(params: dict, opt_state=None, *,
                            device: str | torch.device | None = None
                            ) -> tuple[Layers, OptState | None]:
    """The reference's stacked tree ``{"layers": [{"w": [W, in, out],
    "b": [W, out]}, ...]}`` as port layers, and, if given, its stacked
    ``OptState(step [W], mu, nu)`` as the port's (moments in ``flat``
    order).  Values are copied bit for bit and not transposed."""
    device = resolve_device(device)
    layers = unflat(_tree_to_flat(params, device))
    if opt_state is None:
        return layers, None
    step, mu, nu = opt_state
    return layers, OptState(
        step=torch.from_numpy(np.array(step, np.int32)).to(device),
        mu=_tree_to_flat(mu, device),
        nu=_tree_to_flat(nu, device))


def stacked_params_to_numpy(layers: Sequence[tuple[torch.Tensor, torch.Tensor]],
                            opt_state: OptState | None = None
                            ) -> tuple[dict, dict | None]:
    """The inverse of ``stacked_params_from_jax``: the reference's tree
    layout, and ``{"step", "mu", "nu"}`` for the optimizer state."""
    tree = _flat_to_tree(flat(layers))
    if opt_state is None:
        return tree, None
    return tree, {"step": opt_state.step.detach().cpu().numpy(),
                  "mu": _flat_to_tree(opt_state.mu),
                  "nu": _flat_to_tree(opt_state.nu)}


@dataclass(frozen=True)
class DQNConfig:
    lr: float = 1e-4                 # Table 3
    discount: float = 1.0            # Table 3
    epsilon_initial: float = 1.0     # Table 2 (individual/parallel/general)
    epsilon_decay: float = 0.999     # per-episode; 0.97 for the general model
    epsilon_min: float = 0.01
    batch_size: int = 128            # max training batch (Table 2)
    grad_clip: float = 10.0
    target_update_episodes: int = 1  # Table 3 "Update Episodes 1"
    use_pallas_qnet: bool = False    # kept for config parity; selects nothing


def huber(x: torch.Tensor, delta: float = 1.0) -> torch.Tensor:
    a = torch.abs(x)
    return torch.where(a <= delta, 0.5 * x * x, delta * (a - 0.5 * delta))


def dqn_loss(layers: Sequence[tuple[torch.Tensor, torch.Tensor]],
             target_layers: Sequence[tuple[torch.Tensor, torch.Tensor]],
             batch: dict[str, torch.Tensor], discount: float
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """The double-DQN loss of one parameter set over a dense batch
    (``states [B, in]``, ``next_fps [B, C, in]``, ``next_mask [B, C]``,
    ``rewards``, ``dones`` and, for prioritized replay, ``weights``):
    returns ``(mean Huber loss, |TD| [B])``, the second without history.
    The forwards are the plain ``qnet_ref`` under autograd (the reference
    leaves them to XLA).  The argmax over ``-inf``-masked rows takes the
    first maximum, as ``jnp.argmax`` does; a row with no candidates
    bootstraps 0."""
    q_sa = qnet_ref(batch["states"], layers)
    with torch.no_grad():            # argmax and target: no gradient flows
        q_next_online = qnet_ref(batch["next_fps"], layers)
        q_next_online = torch.where(batch["next_mask"] > 0, q_next_online,
                                    torch.full_like(q_next_online, -torch.inf))
        a_star = torch.argmax(q_next_online, dim=-1)
        q_next_target = qnet_ref(batch["next_fps"], target_layers)
        v_next = torch.gather(q_next_target, -1, a_star.unsqueeze(-1))[..., 0]
        v_next = torch.where(batch["next_mask"].sum(-1) > 0, v_next,
                             torch.zeros_like(v_next))
        y = batch["rewards"] + discount * (1.0 - batch["dones"]) * v_next
    td = q_sa - y
    h = huber(td)
    if "weights" in batch:           # prioritized: importance-weighted mean
        h = h * batch["weights"]
    return torch.mean(h), torch.abs(td).detach()


class DQNAgent:
    """Holds online and target parameters and exposes numpy-facing helpers.

    ``network`` supplies the architecture and the initial weights (a fresh
    He-normal ``QNetwork`` from ``seed`` when None).  Acting dispatches
    through ``fused_qnet``: the CUDA kernel on the card, its plain version
    on the CPU.  ``device=None`` is the GPU."""

    def __init__(self, cfg: DQNConfig, seed: int = 0,
                 network: QNetwork | None = None,
                 device: str | torch.device | None = None):
        self.cfg = cfg
        self.device = resolve_device(device)
        if network is None:
            network = QNetwork(generator=torch.Generator().manual_seed(seed),
                               device=self.device)
        self.params: Layers = [(w.detach().to(self.device).clone(),
                                b.detach().to(self.device).clone())
                               for w, b in network.layers()]
        self.target_params: Layers = [(w.clone(), b.clone())
                                      for w, b in self.params]
        self.opt = adam(cfg.lr, clip_norm=cfg.grad_clip)
        self.opt_state: OptState = self.opt.init(flat(self.params))
        self.epsilon = cfg.epsilon_initial
        self._rng = np.random.default_rng(seed + 1)
        self.n_q_dispatches = 0

    # ---- acting ---------------------------------------------------- #
    def q_values(self, states: np.ndarray) -> np.ndarray:
        """states f32[N, STATE_DIM] -> q f32[N]; one kernel launch."""
        self.n_q_dispatches += 1
        x = torch.from_numpy(np.ascontiguousarray(states, np.float32))
        return fused_qnet(self.params, x.to(self.device)).cpu().numpy()

    def select_action(self, q: np.ndarray) -> int:
        """Decaying eps-greedy (§3.1)."""
        if self._rng.random() < self.epsilon:
            return int(self._rng.integers(0, q.shape[0]))
        return int(np.argmax(q))

    def decay_epsilon(self) -> None:
        self.epsilon = max(self.epsilon * self.cfg.epsilon_decay, self.cfg.epsilon_min)

    # ---- learning -------------------------------------------------- #
    def train_step(self, batch: dict[str, np.ndarray]) -> float:
        dev = {k: torch.from_numpy(np.asarray(v)).to(self.device)
               for k, v in batch.items()}
        leaves = [t.detach().requires_grad_(True) for t in flat(self.params)]
        loss, _ = dqn_loss(unflat(leaves), self.target_params, dev,
                           self.cfg.discount)
        grads = torch.autograd.grad(loss, leaves)
        updates, self.opt_state = self.opt.update(
            list(grads), self.opt_state, [t.detach() for t in leaves])
        self.params = unflat(apply_updates([t.detach() for t in leaves], updates))
        return float(loss.detach())

    def update_target(self) -> None:
        self.target_params = [(w.clone(), b.clone()) for w, b in self.params]

    # state dict for checkpoint / sync
    def get_state(self) -> dict:
        return {"params": self.params, "target": self.target_params,
                "opt": self.opt_state}

    def set_state(self, state: dict) -> None:
        self.params = state["params"]
        self.target_params = state["target"]
        self.opt_state = state["opt"]


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
