"""Port of ``repro.predictors.gnn``: Alfabet-S, the message-passing GNN BDE
predictor (the Alfabet stand-in), as a ``torch.nn.Module``.

Architecture (per St. John et al.'s design, scaled to this problem):
  * atom embedding: linear(ATOM_FEATURE_DIM -> d)
  * T message-passing rounds: per-bond-order linear messages, summed over
    neighbours, gated residual update with layer norm
  * per-atom BDE head: MLP(d -> d/2 -> 1), interpreted as the BDE of that
    atom's O-H bond
  * molecule BDE = min over atoms flagged as O-H oxygens (paper §2.2: "the
    lowest BDE is found among all O-H bonds")

Weights keep the reference's layout, ``w: [in, out]`` and ``b: [out]``,
and ``tree()`` gives them as the reference's parameter tree, so
``params_from_numpy`` / ``params_to_numpy`` carry a tree across as it is
(no transpose) and ``repro_torch.checkpoint.tree_leaves(model.tree())``
lists them in the reference's leaf order.  The message products over
``adj[..., o]`` are ``torch.bmm``; the layer norm is the reference's own
(biased variance, ``rsqrt(var + 1e-6)``); the O-H minimum is
``torch.amin``, which splits the gradient among tied atoms as
``jnp.min`` does.  The reference has no kernel here: these are plain
PyTorch ops on the card, with TF32 off (``device.py``).
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.checkpoint.checkpoint import tree_leaves_with_paths
from repro_torch.chem.molecule import ATOM_FEATURE_DIM, MAX_BOND_ORDER
from repro_torch.device import resolve_device

# normalisation constants for the regression target (kcal/mol)
BDE_MEAN = 80.0
BDE_SCALE = 10.0
_OH_FLAG_CHANNEL = 14  # see to_graph_arrays


class Dense(nn.Module):
    """``x @ w + b`` with ``w [in, out]`` He-normal and ``b [out]`` zero,
    as the reference's ``dense``."""

    def __init__(self, fan_in: int, fan_out: int, generator: torch.Generator | None):
        super().__init__()
        self.w = nn.Parameter(torch.randn(fan_in, fan_out, generator=generator)
                              * (2.0 / fan_in) ** 0.5)
        self.b = nn.Parameter(torch.zeros(fan_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x @ self.w + self.b

    def tree(self) -> dict:
        return {"w": self.w, "b": self.b}


class _Round(nn.Module):
    def __init__(self, d: int, generator: torch.Generator | None):
        super().__init__()
        self.msg = nn.ModuleList([Dense(d, d, generator)
                                  for _ in range(MAX_BOND_ORDER)])
        self.self_ = Dense(d, d, generator)
        self.ln_scale = nn.Parameter(torch.ones(d))
        self.ln_bias = nn.Parameter(torch.zeros(d))

    def tree(self) -> dict:
        return {"msg": [m.tree() for m in self.msg], "self": self.self_.tree(),
                "ln_scale": self.ln_scale, "ln_bias": self.ln_bias}


class AlfabetS(nn.Module):
    """``forward(batch) -> (per_atom_bde [B, A], mol_bde [B])`` in kcal/mol.

    ``batch``: ``atom_feat [B, A, F]``, ``adj [B, A, A, 3]``, ``mask [B, A]``
    (``repro_torch.chem.molecule.to_graph_arrays``, stacked).  Molecules
    with no O-H oxygen get ``mol_bde = +inf`` (callers must mask).
    Initialised He-normal from ``generator`` (other numbers than
    ``jax.random``'s: parity tests carry the reference's params over).
    ``device=None`` is the GPU."""

    def __init__(self, hidden: int = 128, rounds: int = 3, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        d = self.hidden = hidden
        self.n_rounds = rounds
        self.embed = Dense(ATOM_FEATURE_DIM, d, generator)
        self.rounds = nn.ModuleList([_Round(d, generator) for _ in range(rounds)])
        self.head1 = Dense(d, d // 2, generator)
        self.head2 = Dense(d // 2, 1, generator)
        self.to(device)

    def tree(self) -> dict:
        """The parameters as the reference's tree (the tensors themselves)."""
        return {"embed": self.embed.tree(),
                "rounds": [r.tree() for r in self.rounds],
                "head1": self.head1.tree(), "head2": self.head2.tree()}

    def forward(self, batch: dict[str, torch.Tensor]
                ) -> tuple[torch.Tensor, torch.Tensor]:
        feat, mask = batch["atom_feat"], batch["mask"]
        m = mask[..., None]
        adj = batch["adj"].permute(3, 0, 1, 2).contiguous()   # [order, B, A, A]
        h = self.embed(feat) * m
        for rnd in self.rounds:
            msg = torch.zeros_like(h)
            for o, dense in enumerate(rnd.msg):
                msg = msg + torch.bmm(adj[o], dense(h))
            upd = msg + rnd.self_(h)
            upd = _layer_norm(upd, rnd.ln_scale, rnd.ln_bias)
            h = (h + torch.relu(upd)) * m
        z = torch.relu(self.head1(h))
        per_atom = self.head2(z)[..., 0]
        per_atom = per_atom * BDE_SCALE + BDE_MEAN

        oh = feat[..., _OH_FLAG_CHANNEL] * mask  # [B,A] 1.0 on O-H oxygens
        masked = torch.where(oh > 0.5, per_atom,
                             torch.full_like(per_atom, float("inf")))
        mol_bde = torch.amin(masked, dim=-1)
        return per_atom, mol_bde


def _layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = torch.square(x - mu).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale + bias


# ------------------------------------------------------------------ #
# trees <-> modules
# ------------------------------------------------------------------ #
@torch.no_grad()
def load_tree(module: nn.Module, tree: dict) -> None:
    """Copy a numpy parameter tree (the reference's layout) into
    ``module.tree()``'s tensors, bit for bit; shapes must match."""
    src = dict(tree_leaves_with_paths(tree))
    dst = tree_leaves_with_paths(module.tree())
    if sorted(src) != sorted(k for k, _ in dst):
        raise ValueError(f"parameter tree keys {sorted(src)} do not match "
                         f"the module's {sorted(k for k, _ in dst)}")
    for key, t in dst:
        arr = np.array(src[key], np.float32)
        if tuple(arr.shape) != tuple(t.shape):
            raise ValueError(f"{key}: shape {arr.shape} != {tuple(t.shape)}")
        t.copy_(torch.from_numpy(arr))


def tree_to_numpy(module: nn.Module) -> dict:
    """``module.tree()`` with every tensor copied to a numpy array."""
    def conv(x):
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x.detach().cpu().numpy().copy()
    return conv(module.tree())


def params_from_numpy(tree: dict, *,
                      device: str | torch.device | None = None) -> AlfabetS:
    """An ``AlfabetS`` holding the reference's parameter tree (numpy or
    any array ``np.asarray`` takes); hidden width and round count are read
    from the tree."""
    model = AlfabetS(hidden=int(np.shape(tree["embed"]["w"])[1]),
                     rounds=len(tree["rounds"]), device=device)
    load_tree(model, tree)
    return model


def params_to_numpy(model: AlfabetS) -> dict:
    """The inverse of ``params_from_numpy``: the reference's tree layout."""
    return tree_to_numpy(model)

