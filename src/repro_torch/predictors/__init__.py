"""Port of ``repro.predictors``: the learned property predictors,
Alfabet-S (BDE) and AIMNet-S (IP), on the card.

The paper integrates two state-of-the-art predictors: Alfabet (a GNN over
SMILES-derived graphs predicting per-bond BDE, St. John et al. 2020) and
AIMNet-NSE (a 3D-conformer network predicting IP, Zubatyuk et al. 2021).
Neither ships here, so this package provides faithful *small*
re-implementations of their interfaces ("-S" for surrogate), trained
against the chemistry oracle (repro_torch.chem.oracle) to the paper's
reported accuracy envelope (<5% average relative error, §2.2):

``gnn``        Alfabet-S: message-passing GNN, per-atom BDE head, min over
               O-H oxygens (the paper's "BDE" = lowest O-H BDE).
``ip_net``     AIMNet-S: atom features + pseudo-conformer geometry, pooled
               MLP head.  Requires a valid 3D conformer, like the original.
``cache``      the LRU property cache of §3.6.
``service``    PropertyService: batched inference on the card + cache + the
               paper's invalid-conformer protocol; also the oracle stub,
               the degraded tier and the retry wrapper.
``training``   dataset building (incl. RL-trajectory augmentation) and the
               training loops; ``ensure_trained`` caches params on disk.

The names resolve on first use (PEP 562), so importing ``service`` for the
oracle stub does not pull in the training code.
"""

import importlib

_EXPORTS = {
    "repro_torch.predictors.gnn": ("AlfabetS",),
    "repro_torch.predictors.ip_net": ("AIMNetS",),
    "repro_torch.predictors.cache": ("LRUCache",),
    "repro_torch.predictors.service": ("PropertyService",),
    "repro_torch.predictors.training": (
        "ensure_trained", "train_bde_model", "train_ip_model"),
}
_MODULE_OF = {name: mod for mod, names in _EXPORTS.items() for name in names}

__all__ = list(_MODULE_OF)


def __getattr__(name: str):
    if name not in _MODULE_OF:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    return getattr(importlib.import_module(_MODULE_OF[name]), name)
