"""Port of ``repro.predictors.ip_net``: AIMNet-S, the conformer-based IP
predictor (the AIMNet-NSE stand-in), as a ``torch.nn.Module``.

AIMNet-NSE "uses the 3D conformer of molecules to predict IP" (§2.2) — the
property that forces the whole invalid-conformer machinery of §3.3.  This
surrogate keeps that contract: its input features include the pseudo-3D
geometry from ``repro_torch.chem.conformer`` and it cannot run on
molecules whose embedding fails (the service layer translates that into
the paper's -1000 reward).

Architecture: per-atom [chem features ++ geometry features] -> MLP ->
masked mean-pool -> MLP -> scalar IP, averaged over ``n_ensemble`` members
(the paper uses 1 of AIMNet's 5, §3.6).  Weights keep the reference's
``[in, out]`` layout; ``tree()``, ``params_from_numpy`` and
``params_to_numpy`` carry the reference's tree ``{"ensemble": [{"atom1",
"atom2", "pool1", "pool2"}]}`` across as it is.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.chem.conformer import CONFORMER_FEATURE_DIM
from repro_torch.chem.molecule import ATOM_FEATURE_DIM
from repro_torch.device import resolve_device
from repro_torch.predictors.gnn import Dense, load_tree, tree_to_numpy

IP_MEAN = 150.0
IP_SCALE = 25.0


class _Member(nn.Module):
    def __init__(self, in_dim: int, d: int, generator: torch.Generator | None):
        super().__init__()
        self.atom1 = Dense(in_dim, d, generator)
        self.atom2 = Dense(d, d, generator)
        self.pool1 = Dense(d, d // 2, generator)
        self.pool2 = Dense(d // 2, 1, generator)

    def tree(self) -> dict:
        return {"atom1": self.atom1.tree(), "atom2": self.atom2.tree(),
                "pool1": self.pool1.tree(), "pool2": self.pool2.tree()}


class AIMNetS(nn.Module):
    """``forward(batch) -> IP [B]``; ``batch``: ``atom_feat [B, A, F]``,
    ``conf_feat [B, A, G]``, ``mask [B, A]``.  ``device=None`` is the GPU."""

    def __init__(self, hidden: int = 128, n_ensemble: int = 1, *,
                 generator: torch.Generator | None = None,
                 device: str | torch.device | None = None):
        super().__init__()
        device = resolve_device(device)
        self.hidden = hidden
        self.n_ensemble = n_ensemble
        self.ensemble = nn.ModuleList([_Member(self.in_dim, hidden, generator)
                                       for _ in range(n_ensemble)])
        self.to(device)

    @property
    def in_dim(self) -> int:
        return ATOM_FEATURE_DIM + CONFORMER_FEATURE_DIM

    def tree(self) -> dict:
        return {"ensemble": [p.tree() for p in self.ensemble]}

    def forward(self, batch: dict[str, torch.Tensor]) -> torch.Tensor:
        x = torch.cat([batch["atom_feat"], batch["conf_feat"]], dim=-1)
        mask = batch["mask"]
        preds = []
        for p in self.ensemble:
            h = torch.relu(p.atom1(x))
            h = torch.relu(p.atom2(h))
            h = h * mask[..., None]
            pooled = h.sum(dim=1) / torch.clamp(mask.sum(dim=1, keepdim=True),
                                                min=1.0)
            z = torch.relu(p.pool1(pooled))
            out = p.pool2(z)[..., 0]
            preds.append(out * IP_SCALE + IP_MEAN)
        return torch.stack(preds, dim=0).mean(dim=0)


def params_from_numpy(tree: dict, *,
                      device: str | torch.device | None = None) -> AIMNetS:
    """An ``AIMNetS`` holding the reference's parameter tree; hidden width
    and ensemble size are read from the tree."""
    model = AIMNetS(hidden=int(np.shape(tree["ensemble"][0]["atom1"]["w"])[1]),
                    n_ensemble=len(tree["ensemble"]), device=device)
    load_tree(model, tree)
    return model


def params_to_numpy(model: AIMNetS) -> dict:
    """The inverse of ``params_from_numpy``: the reference's tree layout."""
    return tree_to_numpy(model)
